"""Greedy submodular maximization engines (paper Alg. 2 & 3) on PyTorch.

Port of ``repro.core.greedy``.  The reference compiles a whole run into one
XLA program (``lax.fori_loop``) and vmaps the SGE bank; here a run is a
Python loop of device operations, and the bank is one loop over a state
with an explicit leading ``n_subsets`` dimension.  No step reads a device
value back to the host: picks stay device tensors from ``argmax`` to the
state update, so a step costs only kernel launches.

``valid`` masks (``(n,)`` bool) mark real elements: invalid (padding)
elements start pre-selected and are never picked — the exact masking behind
the pow2 class bucketing of ``MiloPreprocessor``.  Where the reference
guards the post-exhaustion steps of ``greedy`` with ``lax.cond``, the loop
here runs the ``n_valid`` real steps and writes the sentinels (index 0,
gain ``_NEG``) for the rest directly — the same outputs.

Randomness: ``stochastic_greedy`` and ``sge`` draw their Gumbel noise from a
``torch.Generator`` on the run's device, or take it through the keyword-only
``noise=`` seam (the parity tests inject the reference's exact JAX draws).

``lazy_greedy`` and ``refine`` are not ported yet (ROADMAP A3).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.submodular import SetFunction, gains_at as _gains_at

_NEG = -1e30


class GreedyResult(NamedTuple):
    indices: torch.Tensor  # (k,) or (B, k) int64 selected order
    gains: torch.Tensor    # same shape, float32 marginal gain at inclusion


def _selected0(n: int, valid: torch.Tensor | None, batch: int, device) -> torch.Tensor:
    """Initial (batch, n) selected mask: padding starts pre-selected."""
    if valid is None:
        return torch.zeros((batch, n), dtype=torch.bool, device=device)
    return (~valid.to(device=device, dtype=torch.bool)).expand(batch, n).clone()


def greedy(
    fn: SetFunction,
    K: torch.Tensor,
    k: int,
    *,
    valid: torch.Tensor | None = None,
    n: int | None = None,
) -> GreedyResult:
    """Exact naive greedy: argmax of the full gain vector each step."""
    n = K.shape[0] if n is None else n
    dev = K.device
    # one host read before the loop: how many steps have a real pick
    n_valid = k if valid is None else min(k, int(valid.sum()))
    state = fn.init(K, 1)
    selected = _selected0(n, valid, 1, dev)
    idxs = torch.zeros((k,), dtype=torch.int64, device=dev)
    gs = torch.full((k,), _NEG, dtype=torch.float32, device=dev)
    for t in range(n_valid):
        masked = fn.gains(state, K).masked_fill(selected, _NEG)
        j = masked.argmax(dim=1)                      # (1,), first max on ties
        gs[t:t + 1] = masked.gather(1, j[:, None])[:, 0]
        idxs[t:t + 1] = j
        state = fn.update(state, K, j)
        selected.scatter_(1, j[:, None], True)
    return GreedyResult(idxs, gs)


def stochastic_candidate_count(n: int, k: int, eps: float) -> int:
    """s = ceil((n/k) * ln(1/eps)), clipped to [1, n]."""
    return max(1, min(n, math.ceil((n / max(k, 1)) * math.log(1.0 / eps))))


def _as_noise(noise, shape: tuple[int, ...], device) -> torch.Tensor:
    t = torch.as_tensor(noise, dtype=torch.float32, device=device)
    if tuple(t.shape) != shape:
        raise ValueError(f"noise has shape {tuple(t.shape)}, expected {shape}")
    return t


def gumbel(shape: tuple[int, ...], generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws: ``-log(E)`` with ``E ~ Exp(1)``."""
    return torch.empty(shape, dtype=torch.float32, device=device).exponential_(
        generator=generator).log_().neg_()


def _stochastic_bank(
    fn: SetFunction,
    K: torch.Tensor,
    k: int,
    *,
    s: int,
    n_runs: int,
    valid: torch.Tensor | None,
    n: int,
    noise: torch.Tensor | None,
    generator: torch.Generator | None,
) -> GreedyResult:
    """``n_runs`` stochastic-greedy runs sharing ``K``, batched on dim 0.

    Per step each run draws its candidate set by Gumbel top-s over its
    unselected elements (uniform sampling without replacement) and adds
    the best candidate by marginal gain (``gains_at`` on the s only).
    """
    dev = K.device
    state = fn.init(K, n_runs)
    selected = _selected0(n, valid, n_runs, dev)
    idxs = torch.zeros((n_runs, k), dtype=torch.int64, device=dev)
    gs = torch.zeros((n_runs, k), dtype=torch.float32, device=dev)
    for t in range(k):
        g = noise[:, t] if noise is not None else gumbel((n_runs, n), generator, dev)
        cand = g.masked_fill(selected, _NEG).topk(s, dim=1).indices       # (B, s)
        cand_gains = _gains_at(fn, state, K, cand)
        # when s exceeds a run's unselected pool, top-s pads the candidates
        # with selected elements: mask them so they can never win
        cand_gains = cand_gains.masked_fill(selected.gather(1, cand), _NEG)
        best_val, arg = cand_gains.max(dim=1)
        best = cand.gather(1, arg[:, None])[:, 0]
        state = fn.update(state, K, best)
        selected.scatter_(1, best[:, None], True)
        idxs[:, t] = best
        gs[:, t] = best_val
    return GreedyResult(idxs, gs)


def stochastic_greedy(
    fn: SetFunction,
    K: torch.Tensor,
    k: int,
    *,
    s: int,
    valid: torch.Tensor | None = None,
    n: int | None = None,
    generator: torch.Generator | None = None,
    noise=None,
) -> GreedyResult:
    """Stochastic greedy (paper Alg. 2 inner loop); ``noise`` (k, n) replaces
    the generator's Gumbel draws, one row per step."""
    n = K.shape[0] if n is None else n
    nz = None if noise is None else _as_noise(noise, (k, n), K.device)[None]
    res = _stochastic_bank(fn, K, k, s=s, n_runs=1, valid=valid, n=n, noise=nz,
                           generator=generator)
    return GreedyResult(res.indices[0], res.gains[0])


def sge(
    fn: SetFunction,
    K: torch.Tensor,
    k: int,
    *,
    n_subsets: int,
    eps: float = 0.01,
    valid: torch.Tensor | None = None,
    s: int | None = None,
    n: int | None = None,
    generator: torch.Generator | None = None,
    noise=None,
) -> torch.Tensor:
    """Paper Alg. 2 (SGE): ``n_subsets`` stochastic-greedy runs as one batch.

    Returns the (n_subsets, k) int64 bank.  ``s`` defaults to the count for
    the physical problem size ``K.shape[0]`` (the padded size when
    bucketed).  ``noise`` (n_subsets, k, n) replaces the Gumbel draws.
    """
    n_ = K.shape[0] if n is None else n
    if s is None:
        s = stochastic_candidate_count(n_, k, eps)
    nz = None if noise is None else _as_noise(noise, (n_subsets, k, n_), K.device)
    return _stochastic_bank(fn, K, k, s=s, n_runs=n_subsets, valid=valid, n=n_,
                            noise=nz, generator=generator).indices


def greedy_importance(
    fn: SetFunction,
    K: torch.Tensor,
    *,
    valid: torch.Tensor | None = None,
    n: int | None = None,
) -> torch.Tensor:
    """Paper Alg. 3: full greedy over the ground set; ``g[e]`` is element
    ``e``'s marginal gain at the moment it was included (its WRE importance).

    Sentinel steps write ``_NEG`` at index 0, so the scatter takes a
    per-element max: any real gain beats the sentinel, and elements never
    really included (padding) end at 0.
    """
    n_ = K.shape[0] if n is None else n
    res = greedy(fn, K, n_, valid=valid, n=n_)
    g = torch.full((n_,), _NEG, dtype=torch.float32, device=K.device)
    g = g.scatter_reduce(0, res.indices, res.gains, reduce="amax")
    return torch.where(g <= _NEG / 2, torch.zeros_like(g), g)
