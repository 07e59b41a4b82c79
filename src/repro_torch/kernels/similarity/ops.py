"""Public dispatch for the similarity kernel: the CUDA kernel for a tensor on
the card, the plain version for a tensor on the CPU.

Unlike the TPU dispatch (``repro/kernels/similarity/ops.py``) nothing is
padded on the main path: the kernel masks ragged tiles itself, so its output
already equals the reference's sliced output.  Only rows that the kernel's
4-element asynchronous copies cannot address in place — not contiguous, a
base off 4-element alignment, or d % 4 != 0 — are copied first: exactly,
into a contiguous tensor, with d zero-padded to a multiple of 4 (zero
columns add fmaf(0, 0, acc) = acc terms, so the output is the same bit for
bit).  ``copies`` counts those copies and each one is logged; the main path
makes none.
"""
from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from repro_torch.kernels.similarity.ref import similarity_ref
from repro_torch.kernels.similarity.similarity import _ENTRY, copy_ready, similarity_cuda

copies = 0
_log = logging.getLogger(__name__)


def copy_operands(zq: torch.Tensor, zk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """zq and zk as the kernel's copies take them: each one that is not
    ``copy_ready`` (both, when d % 4 != 0: zero-padded to the next multiple
    of 4) becomes an exact contiguous copy, counted and logged.  Inputs the
    kernel refuses anyway (dtype, rank, widths) pass through to its checks."""
    global copies
    if (zq.dtype not in _ENTRY or zk.dtype != zq.dtype or zq.dim() != 2 or zk.dim() != 2
            or zq.shape[1] != zk.shape[1]):
        return zq, zk
    pad = -zq.shape[1] % 4
    out = []
    for name, t in (("zq", zq), ("zk", zk)):
        if not pad and copy_ready(t):
            out.append(t)
            continue
        why = (f"d {t.shape[1]} padded to {t.shape[1] + pad}" if pad else
               f"strides {t.stride()}, base {t.data_ptr() % (4 * t.element_size())} bytes "
               "off 4-element alignment")
        t = F.pad(t, (0, pad)) if pad else t.clone(memory_format=torch.contiguous_format)
        copies += 1
        _log.warning("similarity: copied %s %s for the kernel's asynchronous copies (%s)",
                     name, tuple(t.shape), why)
        out.append(t)
    return out[0], out[1]


def similarity(
    zq: torch.Tensor,
    zk: torch.Tensor,
    *,
    normalized: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rescaled cosine Gram ``0.5 + 0.5 * ẑq·ẑkᵀ`` (mq, mk) in fp32.

    A CUDA tensor launches the kernel (or raises); only a CPU tensor takes
    the plain version.  ``out`` optionally receives the result in place.
    """
    if zq.device.type == "cpu":
        res = similarity_ref(zq, zk, normalized=normalized)
        return res if out is None else out.copy_(res)
    return similarity_cuda(*copy_operands(zq, zk), normalized=normalized, out=out)
