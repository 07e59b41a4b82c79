"""Wrapper of the hand-written CUDA SSD chunk kernel (``csrc/ssd_chunk.cu``).

Replaces the TPU kernel ``ssd_chunk_pallas`` (``repro/kernels/ssd_chunk/
ssd_chunk.py``, body ``_ssd_kernel``): one Mamba-2 SSD chunk, f32
throughout — ``y = ((C·Bᵀ)∘exp(cum_t − cum_s)∘tril)·X + (C·h_in)∘exp(cum)``
and ``h_out = exp(cum_L)·h_in + Bᵀ(X∘exp(cum_L − cum))``, with
``cum = cumsum(log max(a, 1e-20))`` and B, C shared across heads.  The
kernel takes strides (unit stride on the last dim) and any chunk length, so
chunk slices of a sequence go in, and y can be written into the sequence's
output, without copies; a short last chunk needs no padding.

``launches`` counts the kernel launches this wrapper made; set it to 0
before a run to read how many that run made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, a, b, c, h_in, y, h_out, strides[19], B, L, H, P, N, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
P_MAX, N_MAX = 64, 128        # csrc/ssd_chunk.cu P_MAX, N_MAX
_HB, _TILE = 4, 64            # heads per y block, rows per tile
_SMEM_MAX = 232448            # bytes of shared memory a Hopper block may use
_GRID_X = 2**31 - 1


def _smem_bytes(L: int) -> int:
    return 4 * (2 * _TILE * (N_MAX + 1) + _TILE * (_TILE + 1) + _TILE * P_MAX + _HB * L)


def ssd_chunk_cuda(x, a, b, c, h_in, *, y=None, h_out=None):
    """Launch the kernel on the current stream for one chunk of L rows:
    x (B, L, H, P), a (B, L, H), b and c (B, L, N), h_in (B, H, N, P), all
    f32 on one card with a unit stride on the last dim.  ``y`` (B, L, H, P)
    and ``h_out`` (B, H, N, P) may be given (views into larger buffers are
    fine); ``h_out`` must not overlap ``h_in``.  Returns (y, h_out)."""
    global launches
    ins = (x, a, b, c, h_in)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError("ssd_chunk_cuda needs every input on one CUDA device "
                         f"(got {[str(t.device) for t in ins]})")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"ssd_chunk_cuda takes float32 inputs (got {[t.dtype for t in ins]})")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 3 or c.shape != b.shape or h_in.dim() != 4:
        raise ValueError("shapes are not x (B, L, H, P), a (B, L, H), b = c (B, L, N), "
                         f"h_in (B, H, N, P): {[tuple(t.shape) for t in ins]}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if tuple(a.shape) != (B, L, H) or tuple(b.shape[:2]) != (B, L) or tuple(h_in.shape) != (B, H, N, P):
        raise ValueError(f"shapes disagree: {[tuple(t.shape) for t in ins]}")
    if P > P_MAX or N > N_MAX:
        raise ValueError(f"head dim {P} > {P_MAX} or state dim {N} > {N_MAX}: beyond the kernel's tiles")
    if _smem_bytes(L) > _SMEM_MAX:
        raise ValueError(f"chunk length {L} needs more shared memory than a block has")
    y = torch.empty((B, L, H, P), dtype=torch.float32, device=dev) if y is None else y
    h_out = torch.empty((B, H, N, P), dtype=torch.float32, device=dev) if h_out is None else h_out
    for name, t, shape in (("y", y, (B, L, H, P)), ("h_out", h_out, (B, H, N, P))):
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float32 {shape} tensor on {dev}")
    if any(t.stride(-1) != 1 for t in (*ins, y, h_out)):
        raise ValueError("ssd_chunk_cuda needs a unit stride on every last dim")
    lo, hi = h_in.data_ptr(), h_in.data_ptr() + 4 * h_in.numel()
    if h_out.data_ptr() < hi and lo < h_out.data_ptr() + 4 * h_out.numel():
        raise ValueError("h_out overlaps h_in")
    if B * H == 0 or L == 0:
        if L == 0:
            h_out.copy_(h_in)
        return y, h_out
    n_blocks = B * (-(-H // _HB)) * (-(-L // _TILE)) + B * H
    if n_blocks > _GRID_X:
        raise ValueError(f"{n_blocks} blocks exceed the kernel's grid")
    strides = (ctypes.c_longlong * 19)(
        *x.stride()[:3], *a.stride()[:3], *b.stride()[:2], *c.stride()[:2],
        *h_in.stride()[:3], *y.stride()[:3], *h_out.stride()[:3])
    fn = _build.function("ssd_chunk_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), h_in.data_ptr(),
                  y.data_ptr(), h_out.data_ptr(), strides, B, L, H, P, N, stream)
    _build.check(code, "ssd chunk kernel launch")
    launches += 1
    return y, h_out
