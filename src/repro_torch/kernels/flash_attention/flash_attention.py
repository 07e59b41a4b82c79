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

Training: ``flash_attention_train_cuda`` runs the bf16 kernel's train
instance (p rounded to bf16 once, as the chunked loop of
``models/attention.py`` rounds it, and each row's log-sum-exp written), and
``flash_attention_bwd_cuda`` its backward (a row pass for D = Σ dO∘O, a dK/dV
kernel over key tiles, a dQ kernel over query tiles; no atomics, so repeats
are bit-equal).  Both take self-attention (Sq = Sk) in bf16 with TMA-ready
operands and count their calls in ``train_launches`` and ``bwd_launches``.
``scored_pairs`` is the (row, key) pairs a kernel's warpgroups score.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0
train_launches = 0
bwd_launches = 0

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# q, k, v, o, strides[12], B, Hq, Hkv, Sq, Sk, D, causal, causal_offset, scale, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
D_MAX = 128            # csrc/flash_attention.cu: the tiles hold D <= 128
BQ_BF16 = 128          # query rows per block of the bf16 kernel (grid y counts them)
BK_BF16 = 128          # keys per tile of the bf16 kernels
WG_ROWS = 64           # query rows (the dK/dV kernel: keys) one consumer warpgroup owns
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


# q, k, v, o, o_lo, lse, strides[12], B, Hq, Hkv, S, D, causal, scale, lse_len, stream
_TRAIN_ARGTYPES = [_P] * 7 + [_I] * 6 + [_F, _I, _P]
# q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, strides[24], B, Hq, Hkv, S, D, causal,
# lse_len, stream
_BWD_ARGTYPES = [_P] * 12 + [_I] * 7 + [_P]


def lse_len(s: int) -> int:
    """Row stride of the log-sum-exp and delta buffers: ``s`` padded to whole
    128-row tiles, so each query step's rows are one aligned bulk copy."""
    return -(-s // BQ_BF16) * BQ_BF16


@functools.lru_cache(maxsize=None)
def scored_pairs(s: int, causal: bool, by_keys: bool) -> int:
    """(query row, key) pairs one head's self-attention over ``s`` positions
    scores in a train kernel, as its warpgroups skip work.  By query rows
    (the forward and the dQ kernel): each 64-row half of a 128-row tile that
    holds a row scores the 128-key tiles that start at or before its last
    row (every tile, non-causal).  By keys (the dK/dV kernel): each 64-key
    half of a 128-key tile that holds a key scores the 64-row query steps
    whose last row reaches its first key (every step, non-causal)."""
    w = WG_ROWS
    if by_keys:
        steps = -(-s // w)
        return sum(steps - (kw0 // w if causal else 0) for kw0 in range(0, s, w)) * w * w
    return sum(-(-(min(row0 + w, s) if causal else s) // BK_BF16)
               for row0 in range(0, s, w)) * w * BK_BF16


def _check_train(q, k, v, extra=()) -> None:
    """Refuse what the train kernels do not take (self-attention, bf16,
    TMA-ready operands, D <= 128)."""
    ts = (q, k, v, *extra)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise _build.KernelInputError("the flash train kernels need every tensor on one CUDA "
                                      f"device (got {[str(t.device) for t in ts]})")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise _build.KernelTypeError("the flash train kernels take bf16 tensors (got "
                                     f"{[t.dtype for t in ts]})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise _build.KernelInputError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                                      f"{tuple(v.shape)} are not (B, Hq, S, D) and two equal "
                                      "(B, Hkv, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise _build.KernelInputError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: the train "
                                      "kernels take self-attention (Sq = Sk) with Hq a "
                                      "multiple of Hkv")
    if d > D_MAX or d % 8 or s == 0 or b * hq == 0:
        raise _build.KernelInputError(f"head dim {d} (at most {D_MAX}, a multiple of 8) or an "
                                      f"empty shape {tuple(q.shape)}")
    if -(-s // BK_BF16) > _GRID_Y or b * hq > _INT_MAX:
        raise _build.KernelInputError(f"shape {tuple(q.shape)} exceeds the kernels' grid")
    if not all(tma_ready(t) for t in ts):
        raise _build.KernelInputError("the flash train kernels' TMA maps need 16-byte-aligned "
                                      "operands with strides of 8-element multiples")


def flash_attention_train_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, scale: float = 1.0,
                               for_backward: bool = True):
    """The bf16 kernel's train instance on the current stream: q (B, Hq, S,
    D), k and v (B, Hkv, S, D) → (o, o_lo, lse): o like q, o_lo its bf16
    remainder (o + o_lo is the f32 output to 2⁻¹⁶), lse (B, Hq,
    ``lse_len(S)``) f32, each row's log-sum-exp of its scaled scores (the
    padding rows are not written).  ``for_backward=False`` (a forward that
    no backward follows) writes o alone and returns (o, None, None)."""
    global train_launches
    _check_train(q, k, v)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    out_lo = lse = None
    if for_backward:
        out_lo = torch.empty_like(out)
        lse = torch.empty((b, hq, lse_len(s)), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
    fn = _build.function("flash_attention_bf16_train", _TRAIN_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if out_lo is None else out_lo.data_ptr(),
                  None if lse is None else lse.data_ptr(), strides, b, hq, k.shape[1], s, d,
                  int(causal), scale, lse_len(s),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash attention train kernel launch")
    train_launches += 1
    return out, out_lo, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             o_lo: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attention_train_cuda`` at scale 1 on the
    current stream: (dq, dk, dv), each laid out like its input, from the
    forward's inputs, its outputs ``o``, ``o_lo`` and ``lse``, and ``dout``
    (o's gradient, TMA-ready like q)."""
    global bwd_launches
    _check_train(q, k, v, (o, o_lo, dout))
    b, hq, s, d = q.shape
    if (o.shape != q.shape or dout.shape != q.shape or o_lo.shape != o.shape
            or o_lo.stride() != o.stride() or lse.shape != (b, hq, lse_len(s))
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise _build.KernelInputError(f"o {tuple(o.shape)}, o_lo {tuple(o_lo.shape)}, dout "
                                      f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not "
                                      f"match q {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(*(x for t in (q, k, v, o, dout, dq, dk, dv)
                                         for x in t.stride()[:3]))
    fn = _build.function("flash_attention_bf16_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), o_lo.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), strides, b, hq, k.shape[1], s, d, int(causal),
                  lse.shape[-1], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash attention backward launch")
    bwd_launches += 1
    return dq, dk, dv
