"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention/flash_attention.py``, body ``_flash_kernel``): causal GQA
attention with an online softmax, the running max, denominator and output
kept in f32, kv head ``h // group`` read in place (K and V never repeated).

Two dtype routes: bf16 runs the warp-specialised tensor-core kernel (``wgmma``
for q·kᵀ and p·v, K/V through a TMA-fed ring in shared memory); f32 runs the
CUDA-core kernel (an f32 input has no exact tensor-core route).  Both take
strides with a unit stride on the head dim, mask ragged query rows, keys and
head dims themselves, and write the output with the same memory layout as q.
The bf16 kernel's TMA maps also need a 16-byte-aligned base, D % 8 == 0 and
row, head and batch strides of 16-byte multiples (``tma_ready``); this
wrapper refuses an input without them, and ``ops.flash_attention`` copies it.

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
D_MAX = 128            # csrc/flash_attention.cu: the tiles hold D <= 128
BQ_BF16 = 128          # query rows per block of the bf16 kernel (grid y counts them)
TMA_ALIGN = 16         # bytes: TMA's base and stride alignment
_INT_MAX = 2**31 - 1
_GRID_Y = 65535


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA map can address the 4-D view ``t`` in
    place: a 16-byte-aligned base, a head dim of 16-byte multiples with unit
    stride, and batch, head and row strides of 16-byte multiples."""
    es = t.element_size()
    return (t.data_ptr() % TMA_ALIGN == 0 and t.shape[3] * es % TMA_ALIGN == 0
            and t.stride(3) == 1 and all(t.stride(i) * es % TMA_ALIGN == 0 for i in range(3)))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream: q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D), one dtype (f32 or bf16), any strides with a unit stride
    on D (bf16: see ``tma_ready``).  Returns (B, Hq, Sq, D) in q's dtype,
    laid out in memory like q.  ``scale`` defaults to 1/√D.

    The causal mask is aligned to the end of the key axis
    (``causal_offset = Sk - Sq``), as in the reference's dispatch.
    """
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise _build.KernelInputError(f"flash_attention_cuda needs q, k and v on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise _build.KernelTypeError(f"flash_attention_cuda takes f32 or bf16 inputs of one dtype "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise _build.KernelInputError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B, Hq, Sq, D) and two equal (B, Hkv, Sk, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise _build.KernelInputError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head dim must "
                         "agree and Hq must be a multiple of Hkv")
    if d > D_MAX:
        raise _build.KernelInputError(f"head dim {d} > {D_MAX}: the kernel's tiles hold at most {D_MAX}")
    if causal and sq > sk:
        raise _build.KernelInputError(f"causal attention with more queries ({sq}) than keys ({sk}) "
                         "leaves rows with no key")
    if any(t.stride(3) != 1 for t in (q, k, v)) and d > 1:
        raise _build.KernelInputError("flash_attention_cuda needs a unit stride on the head dim")
    bf16 = q.dtype == torch.bfloat16
    grid_y = -(-sq // BQ_BF16) if bf16 else b * hq
    if max(sq, sk) > _INT_MAX or b * hq > _INT_MAX or grid_y > _GRID_Y:
        raise _build.KernelInputError(f"shape (B·Hq {b * hq}, Sq {sq}, Sk {sk}) exceeds the kernel's grid")
    if bf16 and sq and sk and not all(tma_ready(t) for t in (q, k, v)):
        raise _build.KernelInputError("the bf16 kernel's TMA maps need 16-byte-aligned q, k and v, D % 8 == 0 "
                         "and row/head/batch strides of 8-element multiples; "
                         "ops.flash_attention copies such inputs")
    out = torch.empty_like(q)  # q's memory layout: unit stride on D, as checked above
    if out.numel() == 0:
        return out
    if sk == 0:
        raise _build.KernelInputError("attention over zero keys")
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.function(_ENTRY[q.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                  b, hq, hkv, sq, sk, d, int(causal), sk - sq,
                  1.0 / (d ** 0.5) if scale is None else scale, stream)
    _build.check(code, "flash attention kernel launch")
    launches += 1
    return out
