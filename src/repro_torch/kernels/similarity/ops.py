"""Public dispatch for the similarity kernel: the CUDA kernel for a tensor on
the card, the plain version for a tensor on the CPU.

Unlike the TPU dispatch (``repro/kernels/similarity/ops.py``) nothing is
padded: the kernel masks ragged tiles itself, so its output already equals
the reference's sliced output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.similarity.ref import similarity_ref
from repro_torch.kernels.similarity.similarity import similarity_cuda


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
    return similarity_cuda(zq, zk, normalized=normalized, out=out)
