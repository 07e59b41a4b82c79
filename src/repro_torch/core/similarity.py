"""Similarity kernels over feature embeddings (port of ``repro.core.similarity``).

The paper settles on the rescaled cosine ``0.5 + 0.5 * <r1, r2> / (|r1||r2|)``
(App. I.2); dot-product and RBF are kept for parity.  Everything is computed
in float32.  ``gram_matrix_blocked(use_pallas=True)`` routes each row tile
through the hand-written CUDA kernel (``repro_torch.kernels.similarity``).
"""
from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["cosine", "dot", "rbf"]


def normalize_rows(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalise rows; zero-norm rows stay exact zero rows (``0 / eps``),
    the padding sentinel the selection engines rely on."""
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(eps)


def zero_norm_rows(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Boolean row mask: rows ``normalize_rows`` would flatten to zero."""
    return torch.linalg.vector_norm(z, dim=-1) <= eps


def cosine_similarity(zq: torch.Tensor, zk: torch.Tensor) -> torch.Tensor:
    """Rescaled cosine similarity in [0, 1] (paper Eq. 10)."""
    return 0.5 + 0.5 * (normalize_rows(zq) @ normalize_rows(zk).T)


def dot_similarity(zq: torch.Tensor, zk: torch.Tensor, *,
                   shift: float | torch.Tensor | None = None) -> torch.Tensor:
    """Dot product shifted to be non-negative; blocked callers pass the
    *global* minimum as ``shift``."""
    s = zq @ zk.T
    if shift is None:
        shift = s.min()
    return s - torch.clamp(torch.as_tensor(shift, dtype=s.dtype, device=s.device), max=0.0)


def _d2(zq: torch.Tensor, zk: torch.Tensor, qq: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    return torch.clamp(qq[:, None] - 2.0 * (zq @ zk.T) + kk[None, :], min=0.0)


def rbf_similarity(zq: torch.Tensor, zk: torch.Tensor, *, kw: float = 0.1,
                   mean_dist: float | torch.Tensor | None = None) -> torch.Tensor:
    """RBF kernel with bandwidth ``kw * mean_dist`` (paper Eq. 11)."""
    d2 = _d2(zq, zk, (zq * zq).sum(-1), (zk * zk).sum(-1))
    if mean_dist is None:
        mean_dist = torch.sqrt(d2 + 1e-12).mean()
    return torch.exp(-d2 / (kw * mean_dist + 1e-12))


def gram_matrix(zq: torch.Tensor, zk: torch.Tensor | None = None, *,
                metric: Metric = "cosine", kw: float = 0.1) -> torch.Tensor:
    """Full pairwise similarity between rows of ``zq`` and ``zk`` in float32."""
    zk = zq if zk is None else zk
    zq, zk = zq.float(), zk.float()
    if metric == "cosine":
        return cosine_similarity(zq, zk)
    if metric == "dot":
        return dot_similarity(zq, zk)
    if metric == "rbf":
        return rbf_similarity(zq, zk, kw=kw)
    raise ValueError(f"unknown metric {metric!r}")


def gram_matrix_blocked(
    z: torch.Tensor,
    *,
    metric: Metric = "cosine",
    block: int = 1024,
    kw: float = 0.1,
    use_pallas: bool = False,
    n_pad: int | None = None,
) -> torch.Tensor:
    """Blocked Gram matrix for large m, built (block × m) row tile by tile.

    ``use_pallas=True`` sends each cosine tile through the CUDA kernel on a
    card (its plain version on the CPU); ``False`` leaves the product to
    ``torch.matmul`` as the reference leaves it to XLA.

    Every tile is written into ONE preallocated output.  With ``n_pad`` the
    output is the (n_pad, n_pad) zero matrix with the Gram in its top-left
    corner — the bucketed engines' exact padding (zero rows and columns).
    This replaces the reference's concatenation plus ``jnp.pad`` copy
    (``repro/core/milo.py`` ``_class_selection``), which holds the unpadded
    and the padded matrix at once: the peak drops from m² + n_pad² floats
    to n_pad² (to half where m is close to n_pad).

    ``dot``'s shift and ``rbf``'s bandwidth are *global* statistics, taken
    over all tiles in a first pass, so every block is the same function.
    """
    m = z.shape[0]
    n_out = m if n_pad is None else n_pad
    if n_out < m:
        raise ValueError(f"n_pad={n_pad} is smaller than the {m} rows")
    z32 = z.float()
    if metric == "cosine":
        z32 = normalize_rows(z32)
    elif metric not in ("dot", "rbf"):
        raise ValueError(f"unknown metric {metric!r}")
    alloc = torch.zeros if n_out > m else torch.empty
    out = alloc((n_out, n_out), dtype=torch.float32, device=z.device)
    tiles = [(lo, min(m, lo + block)) for lo in range(0, m, block)]

    if metric == "cosine":
        if use_pallas:
            from repro_torch.kernels.similarity import ops as sim_ops

            for lo, hi in tiles:
                sim_ops.similarity(z32[lo:hi], z32, normalized=True, out=out[lo:hi, :m])
        else:
            for lo, hi in tiles:
                out[lo:hi, :m] = (z32[lo:hi] @ z32.T).mul_(0.5).add_(0.5)
        return out

    if metric == "dot":
        # the raw tiles ARE the output modulo the shift: one sweep, then an
        # in-place shift of the written block
        shift = None
        for lo, hi in tiles:
            tile = z32[lo:hi] @ z32.T
            out[lo:hi, :m] = tile
            shift = tile.min() if shift is None else torch.minimum(shift, tile.min())
        if shift is not None:
            out[:m, :m] -= torch.clamp(shift, max=0.0)
        return out

    # rbf: two passes, recomputing each d2 tile in the second — holding every
    # d2 tile beside the exp tiles would triple the peak this builder bounds
    sumsq = (z32 * z32).sum(-1)
    total = sum(torch.sqrt(_d2(z32[lo:hi], z32, sumsq[lo:hi], sumsq) + 1e-12).sum()
                for lo, hi in tiles)
    mean_dist = total / (m * m)
    for lo, hi in tiles:
        out[lo:hi, :m] = torch.exp(-_d2(z32[lo:hi], z32, sumsq[lo:hi], sumsq)
                                   / (kw * mean_dist + 1e-12))
    return out
