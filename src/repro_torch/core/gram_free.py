"""Gram-free set functions: selection directly over features, no (n, n) Gram.

Port of ``repro.core.gram_free``.  Under the paper's rescaled cosine

    K_ij = 0.5 + 0.5 · <z_i, z_j>          (z row-normalised)

every access the set functions make to the kernel — a column ``K[:, j]``
(update), a diagonal entry (gains) and graph-cut's one-time column sum — is
an O(n·d) feature contraction, so the ``K`` threaded through the greedy
engines is the row-normalised feature matrix ``z`` (n, d) and memory is
O(n·d + n) instead of O(n²).  States carry the port's leading batch
dimension (one row per run), as in ``core.submodular``.

Facility location is the one function whose gain evaluation still reduces
over the whole ground set: with ``use_pallas=True`` its gains and its lazy
correction go through the CUDA kernels ``fl_gains_gram_free`` and
``fl_gains_gram_free_delta`` (``kernels/fl_gains``), which build similarity
tiles on the fly and never write them out.  The column update (``_sim_col``)
is a plain matrix product, as in the reference.

Padding contract (size bucketing): all-zero feature rows are padding —
facility location pins their cover to +inf at init so they contribute
nothing, and the engines' ``valid`` mask keeps them from being selected.
A genuinely zero-norm data row reaching this layer is treated as padding
too.

Numerics: graph-cut's column sum is computed in closed form
(0.5·n + 0.5·z·Σz), so it can differ from a materialised row sum by ~1 ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.submodular import _DMIN_CAP, LazyHooks, SetFunction, State
from repro_torch.kernels.fl_gains import ops as fl_ops


def _sim_col(z: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Similarity columns ``K[:, j_b]`` on the fly, one row per run: (B, n)."""
    return 0.5 + 0.5 * (z[j] @ z.T)


def _row_sumsq(z: torch.Tensor) -> torch.Tensor:
    return (z * z).sum(-1)


def _sim_matrix(z: torch.Tensor) -> torch.Tensor:
    """Full Gram (``evaluate`` only, never on the selection path); padding
    rows and columns are zero, as in the bucketed dense Gram."""
    live = _row_sumsq(z) > 0.0
    sim = 0.5 + 0.5 * (z @ z.T)
    return torch.where(live[:, None] & live[None, :], sim, torch.zeros_like(sim))


# ---------------------------------------------------------------------------
# Facility location: state c[b, i] = max_{j in S_b} K_ij (+inf on padding rows)
# ---------------------------------------------------------------------------

def make_gram_free_facility_location(*, use_pallas: bool = False) -> SetFunction:
    """Facility location over features; kernel gains when ``use_pallas``
    (on a CUDA ``z``; a CPU ``z`` takes the plain versions)."""

    def init(z: torch.Tensor, batch: int) -> State:
        c0 = torch.where(_row_sumsq(z) > 0.0, 0.0, float("inf")).float()
        return {"c": c0.expand(batch, -1).clone()}

    def gains(state: State, z: torch.Tensor) -> torch.Tensor:
        return fl_ops.fl_gains_gram_free(z, z, state["c"], use_pallas=use_pallas)

    def gains_at(state: State, z: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        return fl_ops.fl_gains_gram_free(z, z[cand], state["c"], use_pallas=use_pallas)

    def update(state: State, z: torch.Tensor, j: torch.Tensor) -> State:
        torch.maximum(state["c"], _sim_col(z, j), out=state["c"])
        return state

    def evaluate(mask: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if not bool(mask.any()):
            return z.new_zeros((), dtype=torch.float32)
        return _sim_matrix(z)[:, mask].max(dim=1).values.sum()

    def delta_gains(z: torch.Tensor, rows: torch.Tensor, c_old: torch.Tensor,
                    c_new: torch.Tensor) -> torch.Tensor:
        return fl_ops.fl_gains_gram_free_delta(z[rows], z, c_old, c_new,
                                               use_pallas=use_pallas)

    name = "gram_free_facility_location" + ("_pallas" if use_pallas else "")
    return SetFunction(name, init, gains, update, evaluate, gains_at=gains_at,
                       lazy=LazyHooks(cover=lambda state: state["c"], delta_gains=delta_gains))


# ---------------------------------------------------------------------------
# Graph cut: colsum in closed form, cur accumulated column by column
# ---------------------------------------------------------------------------

def make_gram_free_graph_cut(lam: float = 0.4) -> SetFunction:
    def init(z: torch.Tensor, batch: int) -> State:
        sumsq = _row_sumsq(z)
        live = sumsq > 0.0
        n_live = live.float().sum()
        # Σ_i K_ij = 0.5·n_live + 0.5·<z_j, Σ_i z_i>; padding rows are zero
        # vectors, so they drop out of both terms
        colsum = 0.5 * n_live + 0.5 * (z @ z.sum(0))
        zero = torch.zeros_like(colsum)
        return {
            "colsum": torch.where(live, colsum, zero),
            "diag": torch.where(live, 0.5 + 0.5 * sumsq, zero),
            "cur": torch.zeros((batch, z.shape[0]), dtype=torch.float32, device=z.device),
        }

    def gains(state: State, z: torch.Tensor) -> torch.Tensor:
        return state["colsum"] - lam * (2.0 * state["cur"] + state["diag"])

    def gains_at(state: State, z: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        return state["colsum"][cand] - lam * (2.0 * state["cur"].gather(1, cand)
                                              + state["diag"][cand])

    def update(state: State, z: torch.Tensor, j: torch.Tensor) -> State:
        state["cur"] += _sim_col(z, j)
        return state

    def evaluate(mask: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        K = _sim_matrix(z)
        m = mask.to(K.dtype)
        return (K @ m).sum() - lam * (m @ K @ m)

    return SetFunction("gram_free_graph_cut", init, gains, update, evaluate,
                       gains_at=gains_at)


# ---------------------------------------------------------------------------
# Disparity-sum / disparity-min: state-only gains, O(n·d) column updates
# ---------------------------------------------------------------------------

def make_gram_free_disparity_sum() -> SetFunction:
    def init(z: torch.Tensor, batch: int) -> State:
        return {"cur": torch.zeros((batch, z.shape[0]), dtype=torch.float32, device=z.device)}

    def gains(state: State, z: torch.Tensor) -> torch.Tensor:
        return 2.0 * state["cur"]

    def gains_at(state: State, z: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        return 2.0 * state["cur"].gather(1, cand)

    def update(state: State, z: torch.Tensor, j: torch.Tensor) -> State:
        state["cur"] += 1.0 - _sim_col(z, j)
        return state

    def evaluate(mask: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        K = _sim_matrix(z)
        m = mask.to(K.dtype)
        return m @ (1.0 - K) @ m - (m * (1.0 - torch.diagonal(K))).sum()

    return SetFunction("gram_free_disparity_sum", init, gains, update, evaluate,
                       gains_at=gains_at)


def make_gram_free_disparity_min() -> SetFunction:
    def init(z: torch.Tensor, batch: int) -> State:
        n = z.shape[0]
        return {
            "dmin": torch.full((batch, n), _DMIN_CAP, dtype=torch.float32, device=z.device),
            "cur": torch.full((batch,), _DMIN_CAP, dtype=torch.float32, device=z.device),
            "size": 0,  # host integer shared by the batch (see core.submodular)
        }

    def gains(state: State, z: torch.Tensor) -> torch.Tensor:
        cur = state["cur"][:, None]
        return torch.minimum(cur, state["dmin"]) - cur

    def gains_at(state: State, z: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        cur = state["cur"][:, None]
        return torch.minimum(cur, state["dmin"].gather(1, cand)) - cur

    def update(state: State, z: torch.Tensor, j: torch.Tensor) -> State:
        dmin = state["dmin"]
        if state["size"] >= 1:
            torch.minimum(state["cur"], dmin.gather(1, j[:, None])[:, 0], out=state["cur"])
        torch.minimum(dmin, 1.0 - _sim_col(z, j), out=dmin)
        state["size"] += 1
        return state

    def evaluate(mask: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        K = _sim_matrix(z)
        n = K.shape[0]
        eye = torch.eye(n, dtype=torch.bool, device=K.device)
        pair = mask[:, None] & mask[None, :] & ~eye
        return torch.where(pair, 1.0 - K, torch.full_like(K, _DMIN_CAP)).min()

    return SetFunction("gram_free_disparity_min", init, gains, update, evaluate,
                       gains_at=gains_at)


# ---------------------------------------------------------------------------
# Query-conditioned facility location (targeted selection)
# ---------------------------------------------------------------------------

def make_query_facility_location(z_query) -> SetFunction:
    """Facility location over a query set: ``f(S) = Σ_q max_{a∈S} sim(a, q)``.

    The state is the per-query cover (B, q).  ``z_query`` (numpy or a
    tensor) must be row-normalised, like the ground features; it moves to
    the ground features' device on first use.  Padding ground rows (all
    zero) have similarity exactly 0.5 to every query, so the cover starts
    at 0.5: their gains are exactly 0.  Plain PyTorch, no kernel.
    """
    if isinstance(z_query, torch.Tensor):
        z_query = z_query.detach().cpu().numpy()
    zq_np = np.ascontiguousarray(np.asarray(z_query, np.float32))
    on_device: dict[torch.device, torch.Tensor] = {}

    def _sim_q(z: torch.Tensor) -> torch.Tensor:
        zq = on_device.get(z.device)
        if zq is None:
            zq = on_device[z.device] = torch.as_tensor(zq_np, device=z.device)
        return 0.5 + 0.5 * (z @ zq.T)  # (..., q)

    def init(z: torch.Tensor, batch: int) -> State:
        return {"c": torch.full((batch, zq_np.shape[0]), 0.5, dtype=torch.float32,
                                device=z.device)}

    def gains(state: State, z: torch.Tensor) -> torch.Tensor:
        # (B, n): Σ_q relu(sim(z_a, q) - c_q)
        return torch.relu(_sim_q(z)[None] - state["c"][:, None, :]).sum(-1)

    def gains_at(state: State, z: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        return torch.relu(_sim_q(z[cand]) - state["c"][:, None, :]).sum(-1)

    def update(state: State, z: torch.Tensor, j: torch.Tensor) -> State:
        torch.maximum(state["c"], _sim_q(z[j]), out=state["c"])
        return state

    def evaluate(mask: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if not bool(mask.any()):
            return z.new_zeros((), dtype=torch.float32)
        return _sim_q(z)[mask].max(dim=0).values.sum()

    return SetFunction("query_facility_location", init, gains, update, evaluate,
                       gains_at=gains_at)


def get_gram_free(name: str, **kwargs) -> SetFunction:
    """Gram-free counterpart of ``submodular.get`` (cosine metric only)."""
    factories = {
        "facility_location": make_gram_free_facility_location,
        "graph_cut": make_gram_free_graph_cut,
        "disparity_sum": make_gram_free_disparity_sum,
        "disparity_min": make_gram_free_disparity_min,
    }
    try:
        return factories[name](**kwargs)
    except KeyError:
        raise KeyError(
            f"no gram-free variant of {name!r}; available: {sorted(factories)}") from None
