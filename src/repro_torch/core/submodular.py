"""Set functions from the paper (App. D), in incremental-gain form.

Port of ``repro.core.submodular`` over a fixed similarity matrix ``K``
((n, n), values in [0, 1]).  Where the reference vmaps one state per greedy
run, here every state carries an explicit leading batch dimension ``B`` (one
row per run of the SGE bank; ``B = 1`` for a single greedy run):

    init(K, B)               -> state                      (dict of tensors)
    gains(state, K)          -> (B, n) marginal gains f(S ∪ j) - f(S)
    gains_at(state, K, cand) -> (B, s) gains for candidate indices (B, s)
    update(state, K, j)      -> state after adding j (B,) to each run's S

``update`` modifies the state's tensors in place (the reference returns new
arrays): a bank at n = 8192 holds (B, n) states that need not be copied on
every one of its k steps.  ``gains_at(state, K, cand)`` equals
``gains(state, K).gather(1, cand)`` bit for bit: facility location sums
its rows in a fixed order (``kernels/fl_gains/ref.py`` ``sum_rows``, and
the CUDA kernels), so a candidate's gain does not depend on the block it
was evaluated in.

``LazyHooks`` let ``greedy.lazy_greedy`` cache facility location's gain
vector and correct it over the rows whose cover moved;
``make_facility_location_pallas`` computes the gains with the CUDA kernel
``fl_gains`` (``kernels/fl_gains``) on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels.fl_gains import ops as fl_ops
from repro_torch.kernels.fl_gains.ref import fl_gains_ref, sum_rows

State = dict[str, Any]

# Large-but-finite stand-in for +inf so disparity-min stays NaN-free.
_DMIN_CAP = 2.0


class LazyHooks(NamedTuple):
    """What the lazy-gain greedy engine (``greedy.lazy_greedy``) needs.

    ``cover(state) -> (B, n)``: the running per-row cover ``c``.
    ``delta_gains(K, rows, c_old_rows, c_new_rows) -> (n,)``: for every
    candidate ``e``, ``sum_i relu(K_ie - c_new_i) - relu(K_ie - c_old_i)``
    over just the given rows.  Rows with an infinite cover in both vectors
    add exact zeros, which is how the engine pads its touched-row block.
    """

    cover: Callable[[State], torch.Tensor]
    delta_gains: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SetFunction:
    """Incremental set-function interface (see module docstring)."""

    name: str
    init: Callable[[torch.Tensor, int], State]
    gains: Callable[[State, torch.Tensor], torch.Tensor]
    update: Callable[[State, torch.Tensor, torch.Tensor], State]
    # f(S) from scratch for a boolean mask (tests and objective checks)
    evaluate: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    gains_at: Callable[[State, torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    # lazy-gain hooks (facility location); None: the engines evaluate every step
    lazy: LazyHooks | None = None


def gains_at(fn: SetFunction, state: State, K: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``fn.gains(state, K).gather(1, cand)`` without the full evaluation when possible."""
    if fn.gains_at is not None:
        return fn.gains_at(state, K, cand)
    return fn.gains(state, K).gather(1, cand)


def _column(K: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``K[:, j]`` for each run, as a (B, n) tensor."""
    return K.index_select(1, j).T


# ---------------------------------------------------------------------------
# Facility location:  f(S) = sum_i max_{j in S} K_ij
# state: c[b, i] = max_{j in S_b} K_ij;  gain(j) = sum_i relu(K_ij - c_i)
# ---------------------------------------------------------------------------

def _fl_init(K: torch.Tensor, batch: int) -> State:
    return {"c": torch.zeros((batch, K.shape[0]), dtype=K.dtype, device=K.device)}


def _fl_gains(state: State, K: torch.Tensor) -> torch.Tensor:
    # one run at a time: an (n, n) block per run, not (B, n, n) at once
    return torch.stack([fl_gains_ref(K, c) for c in state["c"]])


def _fl_gains_at(state: State, K: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    # column gather: O(n·s) per run instead of O(n²); the same fixed-order
    # row sum over the same column values, so bit-equal to ``_fl_gains``
    return torch.stack([fl_gains_ref(K[:, cb], c) for c, cb in zip(state["c"], cand)])


def _fl_update(state: State, K: torch.Tensor, j: torch.Tensor) -> State:
    torch.maximum(state["c"], _column(K, j), out=state["c"])
    return state


def _fl_eval(mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    if not bool(mask.any()):
        return K.new_zeros(())
    return K[:, mask].max(dim=1).values.sum()


def _fl_delta_gains(K: torch.Tensor, rows: torch.Tensor, c_old: torch.Tensor,
                    c_new: torch.Tensor) -> torch.Tensor:
    # row gather: only the (b, n) block of rows whose cover moved is read
    Kb = K.index_select(0, rows).float()
    return sum_rows(torch.relu(Kb - c_new[:, None]) - torch.relu(Kb - c_old[:, None]))


_FL_LAZY = LazyHooks(cover=lambda state: state["c"], delta_gains=_fl_delta_gains)

facility_location = SetFunction("facility_location", _fl_init, _fl_gains, _fl_update,
                                _fl_eval, gains_at=_fl_gains_at, lazy=_FL_LAZY)


# ---------------------------------------------------------------------------
# Graph cut: f(S) = sum_{i in D} sum_{j in S} K_ij - lam * sum_{i,j in S} K_ij
# state: colsum (shared), cur[b, j] = sum_{i in S_b} K_ij
# gain(j) = colsum_j - lam * (2 cur_j + K_jj)
# ---------------------------------------------------------------------------

def make_graph_cut(lam: float = 0.4) -> SetFunction:
    def init(K: torch.Tensor, batch: int) -> State:
        return {"colsum": K.sum(0),
                "cur": torch.zeros((batch, K.shape[0]), dtype=K.dtype, device=K.device)}

    def gains(state: State, K: torch.Tensor) -> torch.Tensor:
        return state["colsum"] - lam * (2.0 * state["cur"] + torch.diagonal(K))

    def gains_at(state: State, K: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        # K[cand, cand] is the pointwise diagonal gather: O(s), not O(n)
        return state["colsum"][cand] - lam * (2.0 * state["cur"].gather(1, cand) + K[cand, cand])

    def update(state: State, K: torch.Tensor, j: torch.Tensor) -> State:
        state["cur"] += _column(K, j)
        return state

    def evaluate(mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
        m = mask.to(K.dtype)
        return (K @ m).sum() - lam * (m @ K @ m)

    return SetFunction("graph_cut", init, gains, update, evaluate, gains_at=gains_at)


graph_cut = make_graph_cut(0.4)


# ---------------------------------------------------------------------------
# Disparity-sum: f(S) = sum_{i,j in S} (1 - K_ij)
# state: cur[b, j] = sum_{i in S_b} (1 - K_ij);  gain(j) = 2 * cur_j
# ---------------------------------------------------------------------------

def _ds_init(K: torch.Tensor, batch: int) -> State:
    return {"cur": torch.zeros((batch, K.shape[0]), dtype=K.dtype, device=K.device)}


def _ds_gains(state: State, K: torch.Tensor) -> torch.Tensor:
    return 2.0 * state["cur"]


def _ds_gains_at(state: State, K: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    return 2.0 * state["cur"].gather(1, cand)


def _ds_update(state: State, K: torch.Tensor, j: torch.Tensor) -> State:
    state["cur"] += 1.0 - _column(K, j)
    return state


def _ds_eval(mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    m = mask.to(K.dtype)
    return m @ (1.0 - K) @ m - (m * (1.0 - torch.diagonal(K))).sum()


disparity_sum = SetFunction("disparity_sum", _ds_init, _ds_gains, _ds_update, _ds_eval,
                            gains_at=_ds_gains_at)


# ---------------------------------------------------------------------------
# Disparity-min: f(S) = min_{i != j in S} (1 - K_ij)
# state: dmin[b, j] = min_{i in S_b} (1 - K_ij), cur[b] = f(S_b), size = |S_b|
# Greedy argmax on gains == farthest-point traversal.
# ---------------------------------------------------------------------------

def _dm_init(K: torch.Tensor, batch: int) -> State:
    n = K.shape[0]
    return {
        "dmin": torch.full((batch, n), _DMIN_CAP, dtype=K.dtype, device=K.device),
        "cur": torch.full((batch,), _DMIN_CAP, dtype=K.dtype, device=K.device),
        # every run of a batch adds one element per update, so the size is a
        # host integer shared by the batch (no device read per step)
        "size": 0,
    }


def _dm_gains(state: State, K: torch.Tensor) -> torch.Tensor:
    cur = state["cur"][:, None]
    return torch.minimum(cur, state["dmin"]) - cur


def _dm_gains_at(state: State, K: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    cur = state["cur"][:, None]
    return torch.minimum(cur, state["dmin"].gather(1, cand)) - cur


def _dm_update(state: State, K: torch.Tensor, j: torch.Tensor) -> State:
    dmin = state["dmin"]
    if state["size"] >= 1:
        torch.minimum(state["cur"], dmin.gather(1, j[:, None])[:, 0], out=state["cur"])
    torch.minimum(dmin, 1.0 - _column(K, j), out=dmin)
    state["size"] += 1
    return state


def _dm_eval(mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    n = K.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=K.device)
    pair = mask[:, None] & mask[None, :] & ~eye
    return torch.where(pair, 1.0 - K, torch.full_like(K, _DMIN_CAP)).min()


disparity_min = SetFunction("disparity_min", _dm_init, _dm_gains, _dm_update, _dm_eval,
                            gains_at=_dm_gains_at)


def make_facility_location_pallas() -> SetFunction:
    """Facility location with the ``fl_gains`` kernel as its gain engine
    (port of the reference's factory of the same name).

    On a CUDA ``K`` the gains launch the hand-written kernel; on a CPU ``K``
    they take its plain version.  Same semantics as ``facility_location``;
    the lazy hooks are the dense row gathers, which need no kernel.
    """

    def gains(state: State, K: torch.Tensor) -> torch.Tensor:
        return fl_ops.fl_gains(K, state["c"])

    def gains_at(state: State, K: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        # gather each run's s candidate columns, then one (B, n, s) launch
        return fl_ops.fl_gains(K[:, cand].movedim(1, 0).contiguous(), state["c"])

    return SetFunction("facility_location_pallas", _fl_init, gains, _fl_update, _fl_eval,
                       gains_at=gains_at, lazy=_FL_LAZY)


REGISTRY = {
    "facility_location": facility_location,
    "graph_cut": graph_cut,
    "disparity_sum": disparity_sum,
    "disparity_min": disparity_min,
}


def get(name: str, **kwargs) -> SetFunction:
    if name == "graph_cut" and kwargs:
        return make_graph_cut(**kwargs)
    return REGISTRY[name]
