"""Plain PyTorch version of the similarity kernel (the CPU path and the
oracle the CUDA kernel is held against on the card)."""
from __future__ import annotations

import torch


def similarity_ref(zq: torch.Tensor, zk: torch.Tensor, *, normalized: bool = False) -> torch.Tensor:
    """Rescaled cosine similarity ``0.5 + 0.5 * <q, k> / (|q||k|)`` in fp32.

    ``zq`` (mq, d) and ``zk`` (mk, d); with ``normalized=True`` the rows are
    taken as already L2-normalised.  Returns (mq, mk) float32.
    """
    zq = zq.float()
    zk = zk.float()
    if not normalized:
        zq = zq / torch.linalg.vector_norm(zq, dim=-1, keepdim=True).clamp_min(1e-8)
        zk = zk / torch.linalg.vector_norm(zk, dim=-1, keepdim=True).clamp_min(1e-8)
    return 0.5 + 0.5 * (zq @ zk.T)
