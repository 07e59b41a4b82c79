"""Plain PyTorch versions of the facility-location gain kernels (the CPU
path and the oracle the CUDA kernels are held against on the card).

Port of ``repro.kernels.fl_gains.ref``, with the same element order: each
ground row's term (``relu(K - c)``, or ``relu(K - c_new) - relu(K - c_old)``
for the lazy delta) is formed per element and only then summed over the
rows — never ``sum(new) - sum(old)``.

Each value depends on its own row and column alone — not on the shape of
the block it was computed in, on the candidate's position or on trailing
exact-zero rows — so ``gains_at`` equals gathered ``gains`` bit for bit and
the lazy engine's two-level gathers are bit-identical on this path too:

- the row sum (``sum_rows``) is a float64 running sum in ground-row order,
  rounded once to float32;
- the gram-free similarities are one float32 matrix product, never a
  matrix-vector one: a one-row operand is given a second row, because the
  CPU BLAS sends a one-row product to its matrix-vector path, which rounds
  an element differently from the matrix product (that product agrees with
  the reference's XLA product element for element on the test fixtures).

Every function takes an optional leading batch dimension: ``c`` of shape
(n,) or (B, n) (one cover per run of a bank), and for the gram-free
functions ``zc`` of shape (s, d) or (B, s, d).
"""
from __future__ import annotations

import torch


def sum_rows(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the ground-row axis (-2) in row order, in float64, rounded
    once to float32 (CPU ``cumsum`` is a sequential scan per column)."""
    return torch.cumsum(terms, dim=-2, dtype=torch.float64)[..., -1, :].float()


def _sim(z: torch.Tensor, zc: torch.Tensor) -> torch.Tensor:
    """Rescaled cosine ``0.5 + 0.5 * <z_i, zc_j>``: (..., n, s) float32."""
    z, zc = z.float(), zc.float()
    n, s = z.shape[-2], zc.shape[-2]
    if n == 1:
        z = torch.cat([z, z], dim=-2)
    if s == 1:
        zc = torch.cat([zc, zc], dim=-2)
    return (0.5 + 0.5 * (z @ zc.mT))[..., :n, :s]


def fl_gains_ref(K: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``g_j = sum_i relu(K_ij - c_i)`` for every candidate column.

    ``K`` (n, n_cand) or (B, n, n_cand) similarity columns, ``c`` (n,) or
    (B, n) running covers; returns (n_cand,) or (B, n_cand) float32.
    """
    return sum_rows(torch.relu(K.float() - c.float()[..., :, None]))


def fl_gains_gram_free_ref(z: torch.Tensor, zc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Gram-free gains: the similarity tile ``0.5 + 0.5 * z @ zcᵀ`` is built
    from row-normalised features instead of read from a Gram.

    ``z`` (n, d) ground rows, ``zc`` (n_cand, d) or (B, n_cand, d)
    candidates, ``c`` (n,) or (B, n); returns (n_cand,) or (B, n_cand).
    """
    return fl_gains_ref(_sim(z, zc), c)


def fl_gains_gram_free_delta_ref(
    z: torch.Tensor, zc: torch.Tensor, c_old: torch.Tensor, c_new: torch.Tensor
) -> torch.Tensor:
    """Lazy-greedy gain correction over the touched rows ``z`` (b, d):
    ``sum_i relu(K_ij - c_new_i) - relu(K_ij - c_old_i)`` per candidate.

    Rows with ``c_old = c_new = +inf`` contribute exact zeros (the padding
    of the engine's touched-row block).  Returns (n_cand,) float32.
    """
    sim = _sim(z, zc)
    new = torch.relu(sim - c_new.float()[..., :, None])
    old = torch.relu(sim - c_old.float()[..., :, None])
    return sum_rows(new - old)


def delta_order_sum(terms: torch.Tensor) -> torch.Tensor:
    """The CUDA delta kernels' fp32 sum of row terms ``terms`` (b, n_cand)
    over the rows, in their fixed order (``csrc/fl_gains.cu``): rows are cut
    into chunks of 256 by absolute index; in a chunk, partial ``P_r``
    (r < 16) adds rows r, r + 16, r + 32, ... to 0 in row order, and the
    chunk's value is ((P_0 + P_1) + P_2) + ... + P_15; chunks are added in
    index order.  Both instances of the delta sum so, so that b rows and the
    same rows padded with exact-zero (``+inf``) rows give one value.
    Returns (n_cand,) float32."""
    terms = terms.float()
    b, m = terms.shape
    total = None
    for lo in range(0, b, 256):
        chunk = terms[lo:lo + 256]
        # rows r + 16 q as [q, r]: the missing rows of a short chunk are
        # zeros, which leave every partial as it is (a partial is never -0)
        rows = torch.zeros((256, m), dtype=torch.float32)
        rows[:len(chunk)] = chunk
        rows = rows.view(16, 16, m)
        part = torch.zeros((16, m), dtype=torch.float32)
        for q in range(16):
            part = part + rows[q]
        value = part[0]
        for r in range(1, 16):
            value = value + part[r]
        total = value if total is None else total + value
    return torch.zeros(m, dtype=torch.float32) if total is None else total
