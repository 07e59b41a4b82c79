"""The SSD chunk kernel's tensor-core arithmetic (its mma instance,
``csrc/ssd_chunk.cu``) in numpy, for holding the kernel against a model of
itself on the CPU.

* ``tf32``: ``cvt.rna.tf32.f32`` by integer arithmetic on the f32 bits.
* ``mma_sum``: one ``mma.sync.m16n8k8`` TF32 k-step, d = a·b + c, as an
  H100's tensor cores compute it.  Found on the card through the kernel
  library's ``ssd_mma_probe`` (``tests/test_torch_cuda.py`` and
  ``chip_smoke.py`` phase 10 hold this model against it bit for bit): the
  eight products are exact; each product, and c, is cut toward zero to a
  multiple of 2^(E − 25), E being the largest exponent among c's and the
  products' (a product's exponent taken as the sum of its operands', its
  significand in [1, 4)); the cut terms are summed exactly and the sum is
  rounded toward zero to f32.  So a running sum carried in c loses up to
  an ulp of itself at every k-step, always toward zero.
* ``split_matmul``: a product through the three-part split, k-step by
  k-step: u_hi = tf32(u), u_lo = tf32(u − u_hi); a_lo·b_hi, a_hi·b_lo and
  a_hi·b_hi summed on the tensor cores from zero, then added to the running
  f32 sum with one f32 add, as the kernel does (``running=True``: the three
  products summed into the running sum on the tensor cores instead).

Operands are f32 arrays of normal numbers (no subnormal, inf or nan is
modelled).
"""
from __future__ import annotations

import numpy as np

_NO_EXP = -(1 << 20)   # the exponent of a zero term: below every other


def tf32(v) -> np.ndarray:
    """Round f32 to TF32, nearest with ties away from zero: half of the 13
    dropped bits added to the magnitude, then the 13 bits cleared."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero_f32(v: np.ndarray) -> np.ndarray:
    f = np.asarray(v.astype(np.float32))
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_sum(a, b, c) -> np.ndarray:
    """d = a·b + c for one k-step: a (..., m, 8) and b (..., 8, n) TF32
    values, c (..., m, n) f32; returns f32 (..., m, n)."""
    a, b, c = (np.asarray(t, dtype=np.float64) for t in (a, b, c))
    prods = a[..., :, :, None] * b[..., None, :, :]                  # (..., m, k, n): exact
    ep = np.frexp(a)[1][..., :, :, None] + np.frexp(b)[1][..., None, :, :]
    ep = np.where(prods == 0, _NO_EXP, ep)
    ec = np.where(c == 0, _NO_EXP, np.frexp(c)[1] + 1)
    # frexp's exponents are one above IEEE's, so the largest here is E + 2
    # and a term's unit 2^(E - 25) is 2^(emax - 27)
    scale = np.ldexp(1.0, np.clip(27 - np.maximum(ep.max(axis=-2), ec), -1000, 1000))
    total = np.trunc(prods * scale[..., None, :]).sum(axis=-2) + np.trunc(c * scale)
    return _toward_zero_f32(total / scale)


def split_matmul(a, b, acc=None, *, running: bool = False) -> np.ndarray:
    """``acc + a @ b`` through the three-part split on the tensor cores:
    a (..., m, K), b (..., K, n) f32, k-steps of 8 in order (K padded with
    zeros); ``acc`` (..., m, n) f32 or None (zeros)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    pad = -a.shape[-1] % 8
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), np.float32)], axis=-1)
        b = np.concatenate([b, np.zeros(b.shape[:-2] + (pad,) + b.shape[-1:], np.float32)], axis=-2)
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    shape = np.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, b.shape[-1]))
    out = np.zeros(shape, np.float32) if acc is None else np.array(acc, np.float32)
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        step = out if running else np.zeros(shape, np.float32)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            step = mma_sum(x[..., k], y[..., k, :], step)
        out = step if running else out + step
    return out
