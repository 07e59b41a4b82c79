"""Wrapper of the hand-written CUDA similarity kernel (``csrc/similarity.cu``).

Replaces the TPU kernel ``similarity_pallas`` (``repro/kernels/similarity/
similarity.py``): ``S = 0.5 + 0.5 * Zq·Zkᵀ`` in fp32 from fp32 or bf16 rows,
with the row normalisation fused when ``normalized=False``.  The kernel masks
ragged edges itself and writes through a row stride, so no padding copy is
made and a tile can be written straight into a larger output.  Its
asynchronous copies move 4 elements at a time, so it takes rows it can
address that way (``copy_ready``); ``ops.similarity`` copies any other input
first.

``launches`` counts the kernel launches this wrapper made; set it to 0 before
a run to read how many that run made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p]
_ENTRY = {torch.float32: "similarity_f32", torch.bfloat16: "similarity_bf16"}
_INT_MAX = 2**31 - 1
_TILE = 128            # output rows (and columns) per block (csrc/similarity.cu BM)


def copy_ready(t: torch.Tensor) -> bool:
    """Whether the kernel's 4-element copies can address the (m, d) rows
    ``t`` in place: contiguous, d % 4 == 0 and a base aligned to 4 elements."""
    return (t.is_contiguous() and t.shape[-1] % 4 == 0
            and t.data_ptr() % (4 * t.element_size()) == 0)


def similarity_cuda(
    zq: torch.Tensor,
    zk: torch.Tensor,
    *,
    normalized: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns ``out`` (mq, mk) fp32.

    ``out`` may be a row-strided view (unit column stride) into a larger
    matrix; without it a fresh (mq, mk) tensor is allocated.
    """
    global launches
    if zq.device.type != "cuda" or zk.device != zq.device:
        raise _build.KernelInputError(f"similarity_cuda needs both inputs on one CUDA device "
                         f"(got {zq.device} and {zk.device})")
    if zq.dtype not in _ENTRY or zk.dtype != zq.dtype:
        raise _build.KernelTypeError(f"similarity_cuda takes fp32 or bf16 inputs of one dtype "
                        f"(got {zq.dtype} and {zk.dtype})")
    if zq.dim() != 2 or zk.dim() != 2 or zq.shape[1] != zk.shape[1]:
        raise _build.KernelInputError(f"shapes {tuple(zq.shape)} and {tuple(zk.shape)} are not "
                         "(mq, d) and (mk, d)")
    if not (copy_ready(zq) and copy_ready(zk)):
        raise _build.KernelInputError("similarity_cuda needs contiguous row-major inputs with d % 4 == 0 "
                         "and bases aligned to 4 elements (ops.similarity copies others)")
    mq, d = zq.shape
    mk = zk.shape[0]
    if max(mq, mk, d) > _INT_MAX or -(-mq // _TILE) > 65535:
        raise _build.KernelInputError(f"shape ({mq}, {mk}, {d}) exceeds the kernel's grid")
    if out is None:
        out = torch.empty((mq, mk), dtype=torch.float32, device=zq.device)
    elif (out.dtype != torch.float32 or out.device != zq.device
          or tuple(out.shape) != (mq, mk) or out.stride(1) != 1
          or out.stride(0) < mk):
        raise _build.KernelInputError("out must be a float32 (mq, mk) view with unit column "
                         "stride on the inputs' device")
    if mq == 0 or mk == 0:
        return out
    fn = _build.function(_ENTRY[zq.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(zq.device).cuda_stream
    with torch.cuda.device(zq.device):
        code = fn(zq.data_ptr(), zk.data_ptr(), out.data_ptr(), mq, mk, d,
                  out.stride(0), int(normalized), stream)
    _build.check(code, "similarity kernel launch")
    launches += 1
    return out
