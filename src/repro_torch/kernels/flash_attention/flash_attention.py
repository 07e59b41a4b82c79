"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention/flash_attention.py``, body ``_flash_kernel``): causal GQA
attention with an online softmax, the running max, denominator and output
kept in f32, kv head ``h // group`` read in place (K and V never repeated).
The kernel takes strides (unit stride on the head dim only), masks ragged
query rows, keys and head dims itself, and writes the output with the same
memory layout as q — so nothing is padded or transposed by a copy.

``launches`` counts the kernel launches this wrapper made; set it to 0
before a run to read how many that run made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# q, k, v, o, strides[12], B, Hq, Hkv, Sq, Sk, D, causal, causal_offset, scale, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
D_MAX = 128            # csrc/flash_attention.cu D_MAX
_INT_MAX = 2**31 - 1
_GRID_Y = 65535


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream: q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D), one dtype (f32 or bf16), any strides with a unit stride
    on D.  Returns (B, Hq, Sq, D) in q's dtype, laid out in memory like q.

    The causal mask is aligned to the end of the key axis
    (``causal_offset = Sk - Sq``), as in the reference's dispatch.
    """
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs q, k and v on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes f32 or bf16 inputs of one dtype "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B, Hq, Sq, D) and two equal (B, Hkv, Sk, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head dim must "
                         "agree and Hq must be a multiple of Hkv")
    if d > D_MAX:
        raise ValueError(f"head dim {d} > {D_MAX}: the kernel's tiles hold at most {D_MAX}")
    if causal and sq > sk:
        raise ValueError(f"causal attention with more queries ({sq}) than keys ({sk}) "
                         "leaves rows with no key")
    if any(t.stride(3) != 1 for t in (q, k, v)) and d > 1:
        raise ValueError("flash_attention_cuda needs a unit stride on the head dim")
    if max(sq, sk) > _INT_MAX or b * hq > _GRID_Y:
        raise ValueError(f"shape (B·Hq {b * hq}, Sq {sq}, Sk {sk}) exceeds the kernel's grid")
    out = torch.empty_like(q)  # q's memory layout: unit stride on D, as checked above
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("attention over zero keys")
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.function(_ENTRY[q.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                  b, hq, hkv, sq, sk, d, int(causal), sk - sq, 1.0 / (d ** 0.5), stream)
    _build.check(code, "flash attention kernel launch")
    launches += 1
    return out
