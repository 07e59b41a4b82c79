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

``lazy_greedy`` caches facility location's gain vector and corrects it
over the rows whose cover moved.  Its branch between a lazy correction and
a full recompute depends on the touched-row count, so each of its steps
reads one count back to the host (the reference's ``lax.cond``).
``refine`` is the hierarchical path's level-1 pass: ``lazy_greedy`` or
``greedy`` over the union of level-0 winners.
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


class LazyGreedyResult(NamedTuple):
    indices: torch.Tensor         # (k,) int64 selected order
    gains: torch.Tensor           # (k,) float32 marginal gain at inclusion
    rows_evaluated: torch.Tensor  # (k,) int64 ground rows contracted per step


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


def _gather_levels(budget: int) -> tuple[int, ...]:
    """Two-level gather sizes: powers of two below ``budget``, then
    ``budget`` itself.  A lazy step gathers the smallest level that covers
    its touched rows instead of the full budget-sized block."""
    levels = []
    size = 1
    while size < budget:
        levels.append(size)
        size <<= 1
    return tuple(levels) + (budget,)


def lazy_greedy(
    fn: SetFunction,
    K: torch.Tensor,
    k: int,
    *,
    budget: int,
    valid: torch.Tensor | None = None,
    n: int | None = None,
    two_level: bool = False,
    verify_argmax: bool = False,
    verify_top: int = 8,
) -> LazyGreedyResult:
    """Exact greedy with lazy gain reuse (``SetFunction.lazy`` hooks).

    The full gain vector is evaluated once and then cached: after adding
    ``j`` only the ground rows whose cover moved can change any gain, so the
    cache is corrected with a delta over just those rows.  When more than
    ``budget`` rows moved the step recomputes the full vector instead, which
    also resets the float drift of the corrections.

    ``rows_evaluated[t]`` is the number of ground rows contracted at step
    ``t``: the gathered block's size on a lazy step, ``n`` on a full
    recompute, 0 on the steps after the valid pool is exhausted — as the
    reference defines it.

    The touched rows are gathered in ascending index order and padded with
    untouched rows at an infinite cover (exact zeros), so the real rows sit
    in the same slots at every block size: ``two_level=True``, which
    gathers the smallest level of ``_gather_levels(budget)`` covering the
    touched count, gives bit-identical results to the single-level path.

    ``verify_argmax=True`` re-evaluates the ``verify_top`` best cached gains
    exactly (``gains_at``) at every step, picks the exact winner with ties
    to the lowest index — ``greedy``'s choice — and writes the exact values
    back into the cache.  The cached gains drift from recomputed ones by a
    few ulps, which can flip sub-ulp near-ties deep into an exhaustive run;
    verification pins the trajectory to ``greedy``'s.
    """
    if fn.lazy is None:
        raise ValueError(f"set function {fn.name!r} provides no lazy hooks; use greedy()")
    n = K.shape[0] if n is None else n
    if not 1 <= budget <= n:
        raise ValueError(f"budget={budget} out of range [1, {n}] (a budget of n already "
                         "contracts every row; use greedy() instead)")
    if verify_argmax and verify_top < 1:
        raise ValueError(f"verify_top={verify_top} must be >= 1")
    v_top = min(verify_top, n)
    levels = _gather_levels(budget) if two_level else (budget,)
    lz = fn.lazy
    dev = K.device
    n_valid = k if valid is None else min(k, int(valid.sum()))
    state = fn.init(K, 1)
    g = fn.gains(state, K)[0]
    selected = _selected0(n, valid, 1, dev)[0]
    idxs = torch.zeros((k,), dtype=torch.int64, device=dev)
    gs = torch.full((k,), _NEG, dtype=torch.float32, device=dev)
    rows = [0] * k
    inf = float("inf")
    for t in range(n_valid):
        if verify_argmax:
            cand = g.masked_fill(selected, _NEG).topk(v_top).indices
            exact = _gains_at(fn, state, K, cand[None])[0].masked_fill(selected[cand], _NEG)
            best = exact.max()
            j = torch.where(exact >= best, cand, n).min()
            gs[t] = best
            g[cand] = exact
        else:
            masked = g.masked_fill(selected, _NEG)
            j = masked.argmax()
            gs[t] = masked[j]
        idxs[t] = j
        c_old = lz.cover(state)[0].clone()   # update works in place
        state = fn.update(state, K, j[None])
        c_new = lz.cover(state)[0]
        touched = c_new > c_old
        touched_rows = touched.nonzero()[:, 0]   # ascending; one host read
        m = touched_rows.numel()
        if m <= budget:
            size = next(lv for lv in levels if lv >= m)
            rows_idx = torch.zeros((size,), dtype=torch.int64, device=dev)
            rows_idx[:m] = touched_rows
            c_o = torch.full((size,), inf, dtype=c_old.dtype, device=dev)
            c_n = c_o.clone()
            c_o[:m] = c_old[touched_rows]
            c_n[:m] = c_new[touched_rows]
            g += lz.delta_gains(K, rows_idx, c_o, c_n)
            rows[t] = size
        else:
            g = fn.gains(state, K)[0]
            rows[t] = n
        selected[j] = True
    return LazyGreedyResult(idxs, gs, torch.tensor(rows, dtype=torch.int64, device=dev))


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
    lazy_budget: int | None = None,
    lazy_two_level: bool = False,
    lazy_verify: bool = False,
) -> torch.Tensor:
    """Paper Alg. 3: full greedy over the ground set; ``g[e]`` is element
    ``e``'s marginal gain at the moment it was included (its WRE importance).

    Sentinel steps write ``_NEG`` at index 0, so the scatter takes a
    per-element max: any real gain beats the sentinel, and elements never
    really included (padding) end at 0.

    ``lazy_budget`` routes the pass through ``lazy_greedy`` when the set
    function has lazy hooks (facility location does) and is ignored
    otherwise; ``lazy_two_level`` and ``lazy_verify`` are its ``two_level``
    and ``verify_argmax``.
    """
    n_ = K.shape[0] if n is None else n
    if lazy_budget is not None and fn.lazy is not None:
        res = lazy_greedy(fn, K, n_, budget=lazy_budget, valid=valid, n=n_,
                          two_level=lazy_two_level, verify_argmax=lazy_verify)
    else:
        res = greedy(fn, K, n_, valid=valid, n=n_)
    g = torch.full((n_,), _NEG, dtype=torch.float32, device=K.device)
    g = g.scatter_reduce(0, res.indices, res.gains, reduce="amax")
    return torch.where(g <= _NEG / 2, torch.zeros_like(g), g)


def refine(
    fn: SetFunction,
    K: torch.Tensor,
    k: int,
    *,
    valid: torch.Tensor | None = None,
    n: int | None = None,
    lazy_budget: int | None = None,
    two_level: bool = False,
    verify_argmax: bool = False,
) -> GreedyResult:
    """Level-1 refine: exact greedy over a union of level-0 winners.

    ``K`` holds only the union's rows.  The lazy engine runs when a budget
    is given, the set function has lazy hooks and ``1 <= lazy_budget < n``
    (the rule ``greedy_importance`` applies); otherwise plain ``greedy``,
    so disparity and graph-cut refines work too.
    """
    n_ = K.shape[0] if n is None else n
    if lazy_budget is not None and fn.lazy is not None and 1 <= lazy_budget < n_:
        res = lazy_greedy(fn, K, k, budget=lazy_budget, valid=valid, n=n_,
                          two_level=two_level, verify_argmax=verify_argmax)
        return GreedyResult(res.indices, res.gains)
    return greedy(fn, K, k, valid=valid, n=n_)
