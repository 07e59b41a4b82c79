"""Wrapper of the hand-written CUDA SSD chunk kernel (``csrc/ssd_chunk.cu``).

Replaces the TPU kernel ``ssd_chunk_pallas`` (``repro/kernels/ssd_chunk/
ssd_chunk.py``, body ``_ssd_kernel``): one Mamba-2 SSD chunk at f32
accuracy — ``y = ((C·Bᵀ)∘exp(cum_t − cum_s)∘tril)·X + (C·h_in)∘exp(cum)``
and ``h_out = exp(cum_L)·h_in + Bᵀ(X∘exp(cum_L − cum))``, with
``cum = cumsum(log max(a, 1e-20))`` and B, C shared across heads.  The
kernel takes strides (unit stride on the last dim) and any chunk length its
shared memory holds (a longer one is refused at launch), so chunk slices of
a sequence go in, and y can be written into the sequence's output, without
copies; a short last chunk needs no padding.

The kernel has two instances, chosen inside its C entry point alone: ``mma``
(the four products on the tensor cores in a three-part TF32 split) for every
call whose loads ``cp.async`` can address and whose sizes its tiles hold,
``simt`` (fp32 on the CUDA cores) for every other call.  The entry point
reports the instance it launched.

``launches`` counts the kernel launches this wrapper made, and
``instance_launches`` the same launches per instance, as the kernel reported
them; set them to 0 before a run to read what that run made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
instance_launches = {"mma": 0, "simt": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, a, b, c, h_in, y, h_out, strides[19], B, L, H, P, N, mma_out, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _P]
_PROBE_ARGTYPES = [_P, _P, _P, _P, _I, _P]   # a, b, c, d, tiles, stream
P_MAX, N_MAX = 64, 128        # the head and state dims both instances' tiles hold


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
    strides = (ctypes.c_longlong * 19)(
        *x.stride()[:3], *a.stride()[:3], *b.stride()[:2], *c.stride()[:2],
        *h_in.stride()[:3], *y.stride()[:3], *h_out.stride()[:3])
    fn = _build.function("ssd_chunk_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mma = _I()
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), h_in.data_ptr(),
                  y.data_ptr(), h_out.data_ptr(), strides, B, L, H, P, N, ctypes.byref(mma),
                  stream)
    _build.check(code, "ssd chunk kernel launch")
    launches += 1
    instance_launches["mma" if mma.value else "simt"] += 1
    return y, h_out


def mma_probe_cuda(a, b, c):
    """d = a·b + c through one ``mma.sync.m16n8k8`` TF32 (the mma instance's
    product instruction) per tile: a (T, 16, 8) and b (T, 8, 8) holding TF32
    values, c (T, 16, 8), f32 on one card.  For holding the tensor cores'
    sum against its model, ``tf32.mma_sum``; not a launch of the kernel."""
    if a.device.type != "cuda" or b.device != a.device or c.device != a.device:
        raise ValueError("mma_probe_cuda needs a, b and c on one CUDA device")
    T = a.shape[0]
    if tuple(a.shape) != (T, 16, 8) or tuple(b.shape) != (T, 8, 8) or tuple(c.shape) != (T, 16, 8):
        raise ValueError(f"shapes are not (T, 16, 8), (T, 8, 8), (T, 16, 8): "
                         f"{[tuple(t.shape) for t in (a, b, c)]}")
    a, b, c = (t.float().contiguous() for t in (a, b, c))
    d = torch.empty_like(c)
    fn = _build.function("ssd_mma_probe", _PROBE_ARGTYPES)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), T,
                  torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(code, "mma probe launch")
    return d
