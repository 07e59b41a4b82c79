"""Multi-device sharded selection: the gram-free engines over a row-sharded
mesh of processes (port of ``repro.core.sharded``).

The reference runs its engines inside ``shard_map`` over a device mesh; here
every rank of a ``distributed.sharding.SelectionMesh`` (one process, one
device) runs the *unchanged* greedy engines of ``core.greedy`` on its own
rows, SPMD — the reference's "2 processes × 1 device = 1 process × 2
devices" equivalence:

  * ``z`` is sharded by rows: rank r holds rows ``[r·n/W, (r+1)·n/W)``.
    This is the only O(n·d) object anywhere.
  * Every per-element vector the engines thread — the ``selected`` mask,
    FL's cover ``c``, graph-cut's ``colsum``/``cur``, disparity state — is
    O(n) and **replicated**: each rank computes the identical pick from
    identical inputs, and the engines' host reads (the lazy engine's
    touched-row count) agree on every rank.
  * Similarity columns ``K[:, j]`` are assembled exactly: the owner rank
    contributes ``z_j`` through a one-owner all-reduce (every other rank
    adds exact zeros), each rank contracts its own rows, and an ordered
    all-gather concatenates the chunks — no cross-rank arithmetic touches
    those values, so graph-cut and disparity gains are the single-device
    ones.
  * Facility-location full gains reduce over the ground-set axis: each rank
    accumulates partial gains for all n candidates with the same
    ``fl_gains_gram_free`` kernel (B2) the single-device path uses,
    visiting candidate blocks around a ring (its own block first, then
    exactly ``W − 1`` hops), and the partials are summed in rank order
    (``SelectionMesh.sum_ordered``) — the same bits on NCCL and gloo and in
    every run, but the float sum is reassociated against the single-device
    one, so FL gains can differ from it by ~1 ulp (held at rtol 1e-6).
  * ``lazy_greedy`` runs unchanged: its delta correction gathers the touched
    rows exactly (one-owner all-reduce), each rank corrects its OWN
    candidate block through ``fl_gains_gram_free_delta`` (B3) and an ordered
    all-gather concatenates, so the corrections are bit-exact against the
    single-device delta; only the cached base gains carry the ring sum's
    ulp.  Near-ties of cached lazy gains can therefore resolve differently
    from the single-device run deep in an exhaustive pass (the reference's
    own forced-8-device lazy cases part the same way).

The mesh is a parameter of the set functions: ``make_sharded_*(mesh=...)``
close over it, as ``shard_map`` binds the reference's axis, and are
memoised on their parameters, mesh included, so two sessions with the same
knobs on the same mesh share one ``ShardedSetFunction``.  The engine
wrappers (``sharded_greedy``, ...) take the mesh too, as the reference's
do, and refuse a set function built for another one.

``compress="int8"`` sends facility location's full-gains sum as
checksummed int8 payloads (``_compressed_psum``): one payload per run of
the batch, and per round three ordered all-gathers carrying every run at
once (the (B, n) int8 block, the (B,) scales and the (B,) checksums).  A
payload whose checksum fails after the collective NaN-poisons the sum, and
the wrapper raises ``CompressionIntegrityError`` on every rank.
``payload_hook`` is the fault seam (``testing.faults.flip_payload_byte``):
it may corrupt this rank's payload block after its checksums were stamped,
as a bad link would.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.gram_free import (
    make_gram_free_disparity_min,
    make_gram_free_disparity_sum,
    make_gram_free_facility_location,
    make_gram_free_graph_cut,
)
from repro_torch.core.greedy import (
    GreedyResult,
    LazyGreedyResult,
    greedy,
    greedy_importance,
    lazy_greedy,
    refine,
    sge,
    stochastic_candidate_count,
    stochastic_greedy,
)
from repro_torch.core.submodular import _DMIN_CAP, LazyHooks, SetFunction, State
from repro_torch.distributed import compression as comp_mod
from repro_torch.distributed.compression import CompressionIntegrityError
from repro_torch.distributed.multihost import RowShard, global_put
from repro_torch.distributed.sharding import SELECTION_AXIS as AXIS
from repro_torch.distributed.sharding import SelectionMesh
from repro_torch.kernels.fl_gains import ops as fl_ops

#: fault seam of the compressed sum: ``payload_hook(call, q)`` may modify
#: this rank's (B, n) int8 payload block ``q`` in place after its checksums
#: were stamped; ``call`` counts this process's payload blocks (one per
#: round) from 1
payload_hook: Callable[[int, torch.Tensor], None] | None = None
_payload_calls = 0


@dataclasses.dataclass(frozen=True)
class ShardedSetFunction(SetFunction):
    """A ``SetFunction`` whose closures run on ``mesh``'s ranks."""

    mesh: SelectionMesh | None = None


# ---------------------------------------------------------------------------
# exact cross-rank primitives (no float reassociation)
# ---------------------------------------------------------------------------

def _offset(mesh: SelectionMesh, z_local: torch.Tensor) -> int:
    return mesh.rank * z_local.shape[0]


def _gather_rows(mesh: SelectionMesh, z_local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Replicated ``z[idx]`` (``idx.shape + (d,)``) from the row-sharded ``z``:
    the owning rank contributes the row, every other rank exact zeros, so
    the all-reduce is a bit-exact gather (one non-zero term per index)."""
    chunk = z_local.shape[0]
    off = _offset(mesh, z_local)
    local = (idx >= off) & (idx < off + chunk)
    rows = z_local[(idx - off).clamp(0, chunk - 1)].float()
    rows = torch.where(local[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return mesh.all_reduce_sum(rows)


def _sim_col(mesh: SelectionMesh, z_local: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Replicated rescaled-cosine columns ``K[:, j_b]``, (B, n): each rank
    computes its rows' dot products (the single-device product's per-row
    reduction) and the chunks are concatenated in rank order."""
    zj = _gather_rows(mesh, z_local, j)
    return mesh.gather_cat(0.5 + 0.5 * (zj @ z_local.T), dim=1)


def _all_row_sumsq(mesh: SelectionMesh, z_local: torch.Tensor) -> torch.Tensor:
    return mesh.gather_cat((z_local * z_local).sum(-1), dim=0)


def _slice_mine(mesh: SelectionMesh, vec: torch.Tensor, z_local: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of a replicated per-row vector (last axis)."""
    off = _offset(mesh, z_local)
    return vec[..., off:off + z_local.shape[0]].contiguous()


def _compressed_psum(mesh: SelectionMesh, x: torch.Tensor, *, rounds: int) -> torch.Tensor:
    """Error-feedback compressed cross-rank sum with integrity checksums.

    Each round every rank int8-quantizes its residual (round 0: its full
    partial) row by row, one payload per run of the batch with its own
    scale and checksum (the reference's vmapped bank quantizes per run);
    it all-gathers the (B, n) block, the scales and the checksums once,
    verifies every peer's checksums after the collective and adds the
    decoded sum in rank order; the local quantization error feeds the next
    round.  A checksum mismatch NaN-poisons the whole output.
    """
    global _payload_calls
    rows = x.reshape(-1, x.shape[-1]).float()
    total = torch.zeros_like(rows)
    resid = rows.clone()
    for _ in range(rounds):
        q, scales = comp_mod.int8_compress_rows(resid)
        sums = comp_mod.payload_checksums(q)
        _payload_calls += 1
        sent = q
        if payload_hook is not None:
            sent = q.clone()
            payload_hook(_payload_calls, sent)
        qs = mesh.all_gather(sent)                             # (W, B, n) int8
        all_scales = mesh.all_gather(scales)                   # (W, B)
        all_sums = mesh.all_gather(sums)                       # (W, B)
        good = (comp_mod.payload_checksums(qs) == all_sums).all()
        acc = qs[0].float() * all_scales[0][:, None]
        for r in range(1, mesh.size):
            acc = acc + qs[r].float() * all_scales[r][:, None]
        total = total + torch.where(good, acc, torch.full_like(acc, float("nan")))
        resid = resid - q.float() * scales[:, None]
    return total.reshape(x.shape)


def _raise_if_corrupt(fn: SetFunction, gains_arr: torch.Tensor) -> None:
    """Loud failure for the compressed path: a checksum mismatch inside the
    collective NaN-poisons the gains; raise the moment they reach the host
    (the values are replicated, so every rank raises)."""
    if "_c8" not in fn.name:
        return
    if bool(torch.isnan(torch.as_tensor(gains_arr)).any()):
        raise CompressionIntegrityError(
            f"{fn.name}: NaN in selection gains — a compressed cross-shard "
            "collective failed its payload checksum (corrupted transfer); "
            "rerun, or disable compression (compress=None) to use the "
            "exact sum"
        )


def _gathered_z_evaluate(base_evaluate, mesh: SelectionMesh):
    """Tests-only ``evaluate``: rebuild full z (all-gather) and delegate."""

    def evaluate(mask: torch.Tensor, z_local: torch.Tensor) -> torch.Tensor:
        return base_evaluate(mask, mesh.gather_cat(z_local, dim=0))

    return evaluate


# ---------------------------------------------------------------------------
# sharded set functions (the engines' "K" argument is the rank's z rows)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def make_sharded_facility_location(
    *,
    mesh: SelectionMesh,
    use_pallas: bool = False,
    compress: str | None = None,
    compress_rounds: int = 2,
) -> ShardedSetFunction:
    """Facility location on ``mesh`` with the cover replicated and every gain
    reduction computed per rank through ``fl_gains_gram_free`` (B2 on a card
    with ``use_pallas``); ``lazy`` hooks with the delta through
    ``fl_gains_gram_free_delta`` (B3).

    ``compress="int8"`` sends the full-gains ring's O(n) cross-rank sum as
    error-feedback int8 payloads with integrity checksums,
    ``compress_rounds`` trading payload for fidelity.  The exact one-owner
    gathers (``gains_at``, ``update``, lazy deltas) are never compressed.
    ``compress=None`` (default) is the exact path."""
    if compress not in ("int8", None):
        raise ValueError(f"unknown compression scheme {compress!r}; one of ('int8', None)")
    base = make_gram_free_facility_location(use_pallas=use_pallas)
    W = mesh.size

    def _kernel(z_local, zc, c_loc):
        return fl_ops.fl_gains_gram_free(z_local, zc, c_loc, use_pallas=use_pallas)

    def init(z_local: torch.Tensor, batch: int) -> State:
        ssq = _all_row_sumsq(mesh, z_local)
        c0 = torch.where(ssq > 0.0, 0.0, float("inf")).float()
        return {"c": c0.expand(batch, -1).clone()}

    def gains(state: State, z_local: torch.Tensor) -> torch.Tensor:
        # Ring schedule: candidate blocks visit every rank, so each rank
        # accumulates its row partial for ALL n candidates while holding at
        # most two (n/W, d) blocks; the first block is the rank's own, so a
        # full evaluation makes exactly W - 1 hops
        chunk = z_local.shape[0]
        c_loc = _slice_mine(mesh, state["c"], z_local)
        out = torch.empty((c_loc.shape[0], W * chunk), dtype=torch.float32,
                          device=z_local.device)
        blk = z_local
        for t in range(W):
            if t:
                blk = mesh.ring_shift(blk)
            src = (mesh.rank + t) % W
            out[:, src * chunk:(src + 1) * chunk] = _kernel(z_local, blk, c_loc)
        if compress == "int8":
            return _compressed_psum(mesh, out, rounds=compress_rounds)
        return mesh.sum_ordered(out)

    def gains_at(state: State, z_local: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        zc = _gather_rows(mesh, z_local, cand)
        return mesh.sum_ordered(_kernel(z_local, zc, _slice_mine(mesh, state["c"], z_local)))

    def update(state: State, z_local: torch.Tensor, j: torch.Tensor) -> State:
        torch.maximum(state["c"], _sim_col(mesh, z_local, j), out=state["c"])
        return state

    def delta_gains(z_local: torch.Tensor, rows: torch.Tensor, c_old: torch.Tensor,
                    c_new: torch.Tensor) -> torch.Tensor:
        # ring-free: the touched rows (small by construction) are gathered
        # exactly, each rank corrects its OWN candidate block, and the
        # ordered all-gather concatenates — per candidate the single-device
        # delta's reduction, so the correction is bit-exact
        zr = _gather_rows(mesh, z_local, rows)
        d_loc = fl_ops.fl_gains_gram_free_delta(zr, z_local, c_old, c_new, use_pallas=use_pallas)
        return mesh.gather_cat(d_loc, dim=0)

    name = "sharded_facility_location" + ("_pallas" if use_pallas else "")
    if compress == "int8":
        name += f"_c8r{compress_rounds}"
    return ShardedSetFunction(name, init, gains, update,
                              _gathered_z_evaluate(base.evaluate, mesh), gains_at=gains_at,
                              lazy=LazyHooks(cover=lambda state: state["c"],
                                             delta_gains=delta_gains),
                              mesh=mesh)


@functools.lru_cache(maxsize=64)
def make_sharded_graph_cut(lam: float = 0.4, *, mesh: SelectionMesh) -> ShardedSetFunction:
    base = make_gram_free_graph_cut(lam)

    def init(z_local: torch.Tensor, batch: int) -> State:
        ssq = _all_row_sumsq(mesh, z_local)
        live = ssq > 0.0
        n_live = live.float().sum()
        # Σ_i z_i reduces over the sharded row axis: summed in rank order, it
        # can differ from the single-device sum by ~1 ulp
        zsum = mesh.sum_ordered(z_local.sum(0))
        colsum = mesh.gather_cat(0.5 * n_live + 0.5 * (z_local @ zsum), dim=0)
        zero = torch.zeros_like(colsum)
        return {
            "colsum": torch.where(live, colsum, zero),
            "diag": torch.where(live, 0.5 + 0.5 * ssq, zero),
            "cur": torch.zeros((batch, ssq.shape[0]), dtype=torch.float32,
                               device=z_local.device),
        }

    def update(state: State, z_local: torch.Tensor, j: torch.Tensor) -> State:
        state["cur"] += _sim_col(mesh, z_local, j)
        return state

    # gains/gains_at read replicated state only: the gram-free closures
    return ShardedSetFunction("sharded_graph_cut", init, base.gains, update,
                              _gathered_z_evaluate(base.evaluate, mesh),
                              gains_at=base.gains_at, mesh=mesh)


@functools.lru_cache(maxsize=64)
def make_sharded_disparity_sum(*, mesh: SelectionMesh) -> ShardedSetFunction:
    base = make_gram_free_disparity_sum()

    def init(z_local: torch.Tensor, batch: int) -> State:
        return {"cur": torch.zeros((batch, mesh.size * z_local.shape[0]), dtype=torch.float32,
                                   device=z_local.device)}

    def update(state: State, z_local: torch.Tensor, j: torch.Tensor) -> State:
        state["cur"] += 1.0 - _sim_col(mesh, z_local, j)
        return state

    return ShardedSetFunction("sharded_disparity_sum", init, base.gains, update,
                              _gathered_z_evaluate(base.evaluate, mesh),
                              gains_at=base.gains_at, mesh=mesh)


@functools.lru_cache(maxsize=64)
def make_sharded_disparity_min(*, mesh: SelectionMesh) -> ShardedSetFunction:
    base = make_gram_free_disparity_min()

    def init(z_local: torch.Tensor, batch: int) -> State:
        n, dev = mesh.size * z_local.shape[0], z_local.device
        return {
            "dmin": torch.full((batch, n), _DMIN_CAP, dtype=torch.float32, device=dev),
            "cur": torch.full((batch,), _DMIN_CAP, dtype=torch.float32, device=dev),
            "size": 0,
        }

    def update(state: State, z_local: torch.Tensor, j: torch.Tensor) -> State:
        dmin = state["dmin"]
        if state["size"] >= 1:
            torch.minimum(state["cur"], dmin.gather(1, j[:, None])[:, 0], out=state["cur"])
        torch.minimum(dmin, 1.0 - _sim_col(mesh, z_local, j), out=dmin)
        state["size"] += 1
        return state

    return ShardedSetFunction("sharded_disparity_min", init, base.gains, update,
                              _gathered_z_evaluate(base.evaluate, mesh),
                              gains_at=base.gains_at, mesh=mesh)


def make_sharded_gram_free(name: str, *, mesh: SelectionMesh, **kwargs) -> ShardedSetFunction:
    """Sharded counterpart of ``gram_free.get_gram_free`` (cosine only) on
    ``mesh``."""
    factories = {
        "facility_location": make_sharded_facility_location,
        "graph_cut": make_sharded_graph_cut,
        "disparity_sum": make_sharded_disparity_sum,
        "disparity_min": make_sharded_disparity_min,
    }
    try:
        factory = factories[name]
    except KeyError:
        raise KeyError(f"no sharded gram-free variant of {name!r}; "
                       f"available: {sorted(factories)}") from None
    return factory(mesh=mesh, **kwargs)


# ---------------------------------------------------------------------------
# engine wrappers: the unchanged greedy engines on every rank
# ---------------------------------------------------------------------------

def _local_rows(fn: SetFunction, z, mesh: SelectionMesh, axis: str) -> tuple[torch.Tensor, int]:
    """(this rank's rows, global n) from a full replicated ``z`` or a
    ``RowShard`` already placed by ``multihost.global_put``."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r} is not {axis!r}")
    if getattr(fn, "mesh", None) is not mesh:
        raise ValueError(f"{fn.name} was not built for this mesh ({mesh!r}): "
                         "build it with make_sharded_*(mesh=mesh)")
    if mesh.rank < 0:
        raise ValueError("this process is not a member of the mesh")
    if isinstance(z, RowShard):
        if z.local.shape[0] * mesh.size != z.n:
            raise ValueError(f"a shard of {z.local.shape[0]} rows is not 1/{mesh.size} of {z.n}")
        return z.local.contiguous(), z.n
    n = z.shape[0]
    if n % mesh.size:
        raise ValueError(
            f"ground-set size {n} is not divisible by the {mesh.size}-device "
            f"{axis!r} mesh; pad the problem (bucketed preprocessing does) "
            "or run the single-device path")
    return global_put(z, mesh, (axis, None)).local.contiguous(), n


def _valid_on(valid: torch.Tensor | None, device) -> torch.Tensor | None:
    return None if valid is None else torch.as_tensor(valid, dtype=torch.bool, device=device)


def sharded_greedy(fn: SetFunction, z, k: int, *, mesh: SelectionMesh, axis: str = AXIS,
                   valid: torch.Tensor | None = None) -> GreedyResult:
    """``greedy`` with z row-sharded over ``mesh`` (trajectory-identical)."""
    zl, n = _local_rows(fn, z, mesh, axis)
    res = greedy(fn, zl, k, valid=_valid_on(valid, zl.device), n=n)
    _raise_if_corrupt(fn, res.gains)
    return res


def sharded_lazy_greedy(fn: SetFunction, z, k: int, *, budget: int, mesh: SelectionMesh,
                        axis: str = AXIS, valid: torch.Tensor | None = None,
                        two_level: bool = False) -> LazyGreedyResult:
    """``lazy_greedy`` with z row-sharded over ``mesh``: full recomputes
    through the (W − 1)-hop ring, delta corrections through the ring-free
    gathered-rows path.  ``rows_evaluated`` counts ground rows contracted,
    as the single-device engine does (the per-rank split of each
    contraction does not change what was evaluated).  ``two_level`` shrinks
    the gathered touched-row block (and its all-reduce payload) to the
    smallest level covering the touched rows, bit-identical."""
    zl, n = _local_rows(fn, z, mesh, axis)
    res = lazy_greedy(fn, zl, k, budget=budget, valid=_valid_on(valid, zl.device),
                      n=n, two_level=two_level)
    _raise_if_corrupt(fn, res.gains)
    return res


def sharded_refine(fn: SetFunction, z, k: int, *, mesh: SelectionMesh, axis: str = AXIS,
                   valid: torch.Tensor | None = None, lazy_budget: int | None = None,
                   lazy_two_level: bool = False) -> GreedyResult:
    """``greedy.refine`` (the hierarchical level-1 pass) over row-sharded z,
    with the single-device entry point's lazy dispatch rule."""
    zl, n = _local_rows(fn, z, mesh, axis)
    res = refine(fn, zl, k, valid=_valid_on(valid, zl.device), n=n,
                 lazy_budget=lazy_budget, two_level=lazy_two_level)
    _raise_if_corrupt(fn, res.gains)
    return res


def sharded_stochastic_greedy(fn: SetFunction, z, k: int, *, s: int, mesh: SelectionMesh,
                              axis: str = AXIS, valid: torch.Tensor | None = None,
                              generator: torch.Generator | None = None,
                              noise=None) -> GreedyResult:
    """``stochastic_greedy`` over row-sharded z.  The Gumbel draws cover the
    global n and every rank draws the same ones (the same seeded generator,
    or the same ``noise``), so the candidate sets are the single-device
    run's."""
    zl, n = _local_rows(fn, z, mesh, axis)
    res = stochastic_greedy(fn, zl, k, s=s, valid=_valid_on(valid, zl.device), n=n,
                            generator=generator, noise=noise)
    _raise_if_corrupt(fn, res.gains)
    return res


def sharded_sge(fn: SetFunction, z, k: int, *, n_subsets: int, eps: float = 0.01,
                s: int | None = None, mesh: SelectionMesh, axis: str = AXIS,
                valid: torch.Tensor | None = None, generator: torch.Generator | None = None,
                noise=None) -> torch.Tensor:
    """The SGE bank (one batched run of ``n_subsets``) over row-sharded z:
    the bank's collectives carry every run at once."""
    zl, n = _local_rows(fn, z, mesh, axis)
    if s is None:
        s = stochastic_candidate_count(n, k, eps)
    return sge(fn, zl, k, n_subsets=n_subsets, eps=eps, valid=_valid_on(valid, zl.device),
               s=s, n=n, generator=generator, noise=noise)


def sharded_greedy_importance(fn: SetFunction, z, *, mesh: SelectionMesh, axis: str = AXIS,
                              valid: torch.Tensor | None = None,
                              lazy_budget: int | None = None,
                              lazy_two_level: bool = False) -> torch.Tensor:
    """``greedy_importance`` over row-sharded z; ``lazy_budget`` routes the
    pass through ``lazy_greedy`` when the set function has lazy hooks
    (sharded facility location does), as on the single-device path."""
    zl, n = _local_rows(fn, z, mesh, axis)
    out = greedy_importance(fn, zl, valid=_valid_on(valid, zl.device), n=n,
                            lazy_budget=lazy_budget, lazy_two_level=lazy_two_level)
    _raise_if_corrupt(fn, out)
    return out
