"""Port parity: the SSD chunk kernel module of ``repro_torch`` against the
JAX reference.

The plain chunk against the reference's oracle (``ssd_chunk_ref``) and its
Pallas kernel in interpret mode, over ``tests/test_ssd_kernel.py``'s sweep;
``ops.ssd_scan`` against the reference's ``ops.ssd_scan`` and the model's
``_ssd_chunk_scan`` at ragged lengths (the port runs a short last chunk
instead of padding it); the state carry composes.  Tolerance 1e-4, as in
``tests/test_ssd_kernel.py``.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py``; here its mma
instance's arithmetic (four products in a three-part TF32 split, the
elementwise work in f32) is emulated on the CPU and held to the same
tolerance, and one TF32 part is shown to fail it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as jops
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jref
from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_pallas
from repro.models.ssm import _ssd_chunk_scan as j_scan
from repro_torch.kernels.ssd_chunk import ops as tops
from repro_torch.kernels.ssd_chunk import ssd_chunk as tkernel
from repro_torch.kernels.ssd_chunk import tf32
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref as tref
from repro_torch.models.ssm import _ssd_chunk_scan as t_scan

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.normal(size=(B, L, H, P)).astype(np.float32),
        rng.uniform(0.6, 1.0, size=(B, L, H)).astype(np.float32),
        rng.normal(size=(B, L, N)).astype(np.float32),
        rng.normal(size=(B, L, N)).astype(np.float32),
        rng.normal(size=(B, H, N, P)).astype(np.float32) * 0.1,
    )
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,L,H,P,N,bh", [
    (1, 8, 4, 4, 4, 4),
    (2, 16, 8, 8, 6, 4),
    (1, 32, 8, 4, 8, 8),
    (1, 64, 16, 16, 16, 8),     # the smoke configuration's widths
])
def test_ssd_chunk_plain_matches_reference(B, L, H, P, N, bh):
    jin, tin = _inputs(L * 7 + H + P + N, B, L, H, P, N)
    y_p, h_p = ssd_chunk_pallas(*jin, block_h=bh, interpret=True)
    y_r, h_r = jax.vmap(jref)(*jin)
    before = tkernel.launches
    y, h = tops.ssd_chunk(*tin)
    assert tkernel.launches == before, "a CPU tensor never launches the kernel"
    for ours, ref in ((y, y_p), (y, y_r), (h, h_p), (h, h_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S,chunk", [(40, 8), (37, 16), (16, 16), (5, 8)])
def test_ssd_scan_matches_reference_scans(S, chunk):
    B, H, P, N = 2, 8, 4, 6
    (x, a, b, c, _), tin = _inputs(S + chunk, B, S, H, P, N)
    y_ref, h_ref = j_scan(x, a, b, c, chunk=chunk, return_state=True)
    y_p, h_p = jops.ssd_scan(x, a, b, c, chunk=chunk, use_pallas=True, block_h=4, interpret=True)
    y, h = tops.ssd_scan(*tin[:4], chunk=chunk)
    y_m, h_m = t_scan(*tin[:4], chunk=chunk, return_state=True)
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, N, P)
    for ours in ((y, h), (y_m, h_m)):
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(y_ref), **TOL)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(h_ref), **TOL)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(y_p), **TOL)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(h_p), **TOL)


def test_ssd_chunk_state_carry_composes():
    """Two chunks of the plain version == one double-length reference chunk."""
    B, L, H, P, N = 1, 8, 4, 4, 4
    jin, (x, a, b, c, h0) = _inputs(11, B, 2 * L, H, P, N)
    y_full, h_full = jax.vmap(jref)(*jin)
    y1, h1 = tref(x[:, :L], a[:, :L], b[:, :L], c[:, :L], h0)
    y2, h2 = tref(x[:, L:], a[:, L:], b[:, L:], c[:, L:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), np.asarray(y_full), **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_full), **TOL)


def test_short_last_chunk_equals_reference_padding():
    """The port runs a ragged last chunk as a shorter chunk; the reference
    pads it with a = 1 and b = c = x = 0.  Both give the same outputs."""
    B, L, H, P, N = 1, 16, 4, 4, 5
    _, (x, a, b, c, h0) = _inputs(13, B, 11, H, P, N)
    pad = L - 11
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    ap = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    bp, cp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (b, c))
    y_pad, h_pad = tref(xp, ap, bp, cp, h0)
    y, h = tref(x, a, b, c, h0)
    np.testing.assert_allclose(y.numpy(), y_pad[:, :11].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), h_pad.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the mma instance's arithmetic (csrc/ssd_chunk.cu), emulated
# ---------------------------------------------------------------------------

def _mm(a, b, parts, acc=None, running=False):
    """``acc + a @ b`` as the kernel's products: ``parts=3`` the three-part
    split k-step by k-step on the model of the tensor cores (``tf32.py``),
    the running sum out of them unless ``running``; ``parts=1`` one TF32
    part, a_hi·b_hi; ``parts=0`` the f32 product."""
    if parts == 3:
        return tf32.split_matmul(a, b, acc, running=running)
    out = a @ b if parts == 0 else tf32.tf32(a) @ tf32.tf32(b)
    return out if acc is None else acc + out


def _ssd_chunk_mma(x, a, b, c, h_in, parts=3, running=False):
    """One chunk (torch f32 tensors in, numpy f32 out) through the mma
    instance's products, ``_mm``: c·bᵀ, then c·h_in scaled by exp(cum_t)
    with the weighted (L, L)·(L, P) added to it, and bᵀ·(x∘rem).  The
    elementwise work is the plain version's own f32 ops (cum in row order,
    the decay exp(cum_t − cum_s) of the difference, the weight s_ts·decay
    formed before the split), so the products alone part the two."""
    cum = torch.cumsum(torch.log(torch.clamp_min(a, 1e-20)), dim=1)              # (B, L, H)
    L = x.shape[1]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, :, :, None]
    decay = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None]), torch.zeros(()))
    scores = torch.from_numpy(_mm(c.numpy(), b.transpose(1, 2).numpy(), parts, running=running))
    w = (scores[..., None] * decay).permute(0, 3, 1, 2).numpy()                    # (B, H, t, s)
    inter = _mm(c[:, None].numpy(), h_in.numpy(), parts, running=running) * (
        torch.exp(cum).transpose(1, 2)[..., None].numpy())                        # (B, H, t, P)
    y = _mm(w, x.transpose(1, 2).numpy(), parts, inter, running=running).transpose(0, 2, 1, 3)
    tot = cum[:, -1]                                                               # (B, H)
    xr = (x * torch.exp(tot[:, None] - cum)[..., None]).transpose(1, 2).numpy()    # (B, H, s, P)
    h_out = (torch.exp(tot)[..., None, None] * h_in).numpy() + _mm(
        b.transpose(1, 2)[:, None].numpy(), xr, parts, running=running)
    return y, h_out


def _excess(ours, ref):
    """max |ours − ref| / (atol + rtol·|ref|): ≤ 1 passes ``TOL``."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(ours - ref) / (TOL["atol"] + TOL["rtol"] * np.abs(ref))))


def test_tf32_rounding_keeps_ten_bits_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)
    v = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23, 1 + 3 * 2.0**-11,
                  np.float32(np.pi), 0.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.140625, 0.0], np.float32)
    np.testing.assert_array_equal(tf32.tf32(v), want)
    u = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    hi = tf32.tf32(u)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.all(np.abs(u - hi) <= np.abs(u) * 2.0**-11)
    lo = tf32.tf32(u - hi)
    assert np.all(np.abs(u - hi - lo) <= np.abs(u) * 2.0**-21)


def test_the_tensor_core_sum_model_cuts_and_rounds_toward_zero():
    """``tf32.mma_sum`` on sums whose answer is known: exact when no term
    falls below 2^(E − 25); a term under that unit cut away; a sum between
    two f32 values rounded toward zero, for either sign."""
    def one(pairs, c):
        a, b = np.zeros((1, 8), np.float32), np.zeros((8, 1), np.float32)
        for k, (u, v) in enumerate(pairs):
            a[0, k], b[k, 0] = u, v
        d = tf32.mma_sum(a, b, np.float32([[c]]))
        assert d.dtype == np.float32
        return d[0, 0]

    assert one([(1.5, 2.0), (0.75, 4.0)], 0.25) == 6.25
    # 1 + 2^-23 - 2^-26: the product is under the unit 2^-25 and cut, where
    # the exact sum would round (either way) to 1
    assert one([(-(2.0**-13), 2.0**-13)], 1 + 2.0**-23) == np.float32(1 + 2.0**-23)
    for sign in (1.0, -1.0):   # ±(1 + 3·2^-25): to nearest ±(1 + 2^-23), toward zero ±1
        assert one([(sign * 1.5, 2.0**-24)], sign) == sign
    rng = np.random.default_rng(1)
    a, b = (tf32.tf32(rng.normal(size=s).astype(np.float32)) for s in ((64, 16, 8), (64, 8, 8)))
    c = rng.normal(size=(64, 16, 8)).astype(np.float32)
    prods = a[:, :, :, None].astype(np.float64) * b[:, None].astype(np.float64)
    exact = prods.sum(axis=2) + c
    biggest = np.maximum(np.abs(prods).max(axis=2), np.abs(c))
    d = tf32.mma_sum(a, b, c).astype(np.float64)
    assert np.all(np.abs(d - exact) <= 2.0**-20 * biggest)
    a, b, c = np.abs(a), np.abs(b), np.abs(c)   # one sign: never above the exact sum
    d = tf32.mma_sum(a, b, c).astype(np.float64)
    assert np.all(d <= np.einsum("tik,tkj->tij", a.astype(np.float64), b.astype(np.float64)) + c)


MMA_CASES = [
    (1, 8, 4, 4, 4), (2, 16, 8, 8, 6), (1, 32, 8, 4, 8), (1, 64, 16, 16, 16),  # the sweep above
    (1, 256, 4, 64, 128),    # Jamba's widths (4 of its 256 heads)
    (1, 245, 4, 64, 128),    # a ragged last chunk at those widths
]


@pytest.mark.parametrize("B,L,H,P,N", MMA_CASES)
def test_ssd_chunk_mma_arithmetic_matches_plain_and_reference(B, L, H, P, N):
    jin, tin = _inputs(L * 7 + H + P + N, B, L, H, P, N)
    y, h = _ssd_chunk_mma(*tin)
    assert y.dtype == h.dtype == np.float32
    y_t, h_t = tref(*tin)
    y_j, h_j = jax.vmap(jref)(*jin)
    for ours, ref in ((y, y_t), (h, h_t), (y, y_j), (h, h_j)):
        np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def _jamba_chunk(L):
    """4 of Jamba's 256 heads at its widths (P 64, N 128), L rows."""
    B, H, P, N = 1, 4, 64, 128
    _, tin = _inputs(L * 7 + H + P + N, B, L, H, P, N)
    y_t, h_t = tref(*tin)
    return tin, y_t.numpy(), h_t.numpy()


@pytest.mark.parametrize("L", [256, 245])
def test_ssd_chunk_one_tf32_part_fails_the_tolerance(L):
    """The reason for the split: at Jamba's widths one TF32 part misses
    ``TOL`` two hundred times over, where three parts take a fifth of it
    (~6e-5 of |y| ≤ 175), and f32 products in the same order a thirtieth."""
    tin, y_t, h_t = _jamba_chunk(L)
    y0, h0 = _ssd_chunk_mma(*tin, parts=0)
    y3, h3 = _ssd_chunk_mma(*tin, parts=3)
    y1, h1 = _ssd_chunk_mma(*tin, parts=1)
    assert max(_excess(y0, y_t), _excess(h0, h_t)) <= 0.05
    assert max(_excess(y3, y_t), _excess(h3, h_t)) <= 0.25
    assert max(_excess(y3, y0), _excess(h3, h0)) <= 0.25
    assert _excess(y1, y_t) > 100.0 and _excess(y1, y0) > 100.0


@pytest.mark.parametrize("L", [256, 245])
def test_ssd_chunk_running_sum_through_the_tensor_cores_costs_more(L):
    """The reason each k-step's products are summed from zero and added
    with an f32 add: carried through the tensor cores, which round toward
    zero, the running sum ends half again as far or more from the plain
    chunk.  ``tf32.mma_sum`` is the card's own sum: ``chip_smoke.py`` phase
    10 and the card tests hold it against the tensor cores bit for bit."""
    tin, y_t, h_t = _jamba_chunk(L)
    fresh = _excess(_ssd_chunk_mma(*tin)[0], y_t)
    running = _excess(_ssd_chunk_mma(*tin, running=True)[0], y_t)
    assert running >= 1.5 * fresh and running <= 1.0, (fresh, running)


def test_the_kernels_source_entry_points_match_the_bindings():
    """``ssd_chunk_f32`` in ``csrc/ssd_chunk.cu`` takes the wrapper's
    ctypes arguments in order — its instance report as ``int*`` before the
    stream — and so does ``ssd_mma_probe``; every other entry point there
    is a shared-memory report."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tkernel.__file__).parents[2] / "csrc" / "ssd_chunk.cu").read_text()
    entries = {name: [p.strip() for p in params.split(",") if p.strip()]
               for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}

    def kind(param: str):
        if re.match(r"int\s*\*", param):
            return ctypes.POINTER(ctypes.c_int)
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_int

    assert [kind(p) for p in entries["ssd_chunk_f32"]] == tkernel._ARGTYPES
    assert entries["ssd_chunk_f32"][-2] == "int* mma_out"
    assert [kind(p) for p in entries["ssd_mma_probe"]] == tkernel._PROBE_ARGTYPES
    assert set(entries) == {"ssd_chunk_f32", "ssd_mma_probe", "ssd_chunk_mma_smem_bytes",
                            "ssd_chunk_simt_smem_bytes"}


def test_a_cpu_tensor_counts_no_launch_of_either_instance():
    _, tin = _inputs(3, 1, 8, 4, 4, 4)
    before = (tkernel.launches, dict(tkernel.instance_launches))
    tops.ssd_chunk(*tin)
    tops.ssd_scan(*tin[:4], chunk=4)
    assert (tkernel.launches, tkernel.instance_launches) == before
    assert set(tkernel.instance_launches) == {"mma", "simt"}
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_chunk_cuda(*tin)
