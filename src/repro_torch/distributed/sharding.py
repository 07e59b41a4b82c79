"""Sharding on ``torch.distributed``: the LM's rules on DTensor, and the
selection mesh (port of ``repro.distributed.sharding``).

**The LM rules** map the parameter tree, the activations and the caches of
``models.lm`` onto a ``DeviceMesh`` of named axes:

  * ``pod``   — outer pure data parallelism (gradients all-reduced across pods),
  * ``data``  — FSDP: parameters and optimizer state sharded, gathered on use,
  * ``model`` — tensor and expert parallelism: heads, FFN, vocabulary, experts.

They are the reference's, dim for dim, and divisibility-aware: a dim that the
mesh axis does not divide is replicated, never padded (granite's vocabulary
49,155 over ``model``, whisper's 12 heads).  A rule gives a *spec*, one
entry per tensor dim (a mesh axis name, a tuple of them, or None: the
reference's ``PartitionSpec``), and ``placements`` turns a spec into
DTensor placements, one per mesh dim.  The rules read only the mesh's axis
names and sizes (``mesh_dim_names``, ``shape``), so any object with those
two attributes drives them.

The port holds a leaf that the reference stacks over the layer groups as a
``tree.Stacked`` list of per-group tensors without the leading ``n_groups``
axis, so its rule has no leading ``None`` for that axis; its path is still
the reference's (``groups/b0/mixer/wq``): the rule keys on it.

``constrain`` pins an activation's layout at the reference's sites in the
models.  The mesh it reads is *ambient*: entered with ``use_mesh(mesh)``
and held in a context variable, so a mesh entered in one thread (a server's
session worker) is never ambient in another.  Without an ambient mesh, or
for a plain tensor, ``constrain`` returns its input itself, and the models
compute bit for bit what they compute without this module.

**The selection mesh** (``SELECTION_AXIS``, ``selection_mesh``): the
ground-set row axis over the ranks of a ``torch.distributed`` process group.
A ``SelectionMesh`` is a small object: the process group, its size, this
process's rank in it, the axis name and the device the rank computes on.
It is also the port's collective layer.  The sharded engines
(``core.sharded``) call only its methods, each of which fixes its order of
operations so that every backend and every run gives the same bits:

  * ``all_gather`` / ``gather_cat``: the ranks' tensors in rank order (the
    reference's ``all_gather``, tiled or stacked);
  * ``sum_ordered``: an ordered ``all_gather`` then a sum in rank order —
    the reference's ``psum`` of a float vector.  NCCL's ring all-reduce does
    not fix its order; this does;
  * ``all_reduce_sum``: an all-reduce, used only where each element has
    exactly one non-zero term (the one-owner row gather), so it is exact;
  * ``ring_shift``: one hop of the ring (``ppermute`` to rank − 1, from
    rank + 1), counted in ``hops``.

One rank per process and one device per rank.  NCCL refuses two ranks on
one card, so ranks that share a card run gloo, and gloo sends no CUDA
tensor point to point: under gloo each CUDA tensor is staged through host
memory here, and only here, counted in ``staged_calls`` / ``staged_bytes``.
The kernels still run on the card; the staging changes only the transport.
A collective whose peer died raises ``HostLossError``.

Without an initialised process group the mesh has one member and every
collective is the identity, so the sharded engines run on one process as
they do on many (the reference's single-device mesh).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.distributed import multihost
from repro_torch.distributed.fault_tolerance import HostLossError
from repro_torch.kernels import _shards

#: mesh axis name carrying the selection ground-set (row) axis
SELECTION_AXIS = "sel"

# the wording of the transports' errors that means a peer is gone or late
# (gloo: "Connection closed by peer", "Connection reset by peer", "Timed out
# waiting ..."; NCCL's watchdog: "... collective operation timeout", "remote
# process exited or there was a network error"); every other error of a
# live job (invalid usage, out of memory) propagates as it is
_LOSS_WORDS = ("timed out", "timeout", "connection closed", "closed by peer",
               "connection reset", "reset by peer", "broken pipe", "remote process exited")


def is_host_loss(err: BaseException) -> bool:
    """Whether a collective's error means a peer is dead or unreachable."""
    network = getattr(torch.distributed, "DistNetworkError", ())
    return isinstance(err, network) or any(w in str(err).lower() for w in _LOSS_WORDS)


def _dist():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


class SelectionMesh:
    """1-D mesh of ranks for the selection row axis, and its collectives."""

    def __init__(self, group, ranks: tuple[int, ...], rank: int, *,
                 axis: str = SELECTION_AXIS, device: torch.device | None = None,
                 backend: str | None = None):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = rank
        self.axis = axis
        self.device = torch.device("cpu") if device is None else device
        self.backend = backend
        self.shape = {axis: self.size}
        self.reset_counts()

    def __repr__(self) -> str:
        return (f"SelectionMesh(axis={self.axis!r}, size={self.size}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")

    def reset_counts(self) -> None:
        """Zero the counters: ``hops`` (ring hops), ``collectives`` (calls
        into ``torch.distributed``), ``staged_calls`` and ``staged_bytes``
        (CUDA tensors sent through host memory under gloo, both ways)."""
        self.hops = 0
        self.collectives = 0
        self.staged_calls = 0
        self.staged_bytes = 0

    # -- transport -----------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self._staged(t):
            self.staged_calls += 1
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _from_wire(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if t.device != like.device:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    def _call(self, what: str, fn, *args, **kwargs):
        self.collectives += 1
        try:
            return fn(*args, group=self.group, **kwargs)
        except RuntimeError as e:
            if is_host_loss(e):
                raise HostLossError(
                    f"{what} on the {self.size}-rank {self.axis!r} mesh failed: a peer is "
                    f"dead or unreachable ({e})") from e
            raise

    # -- collectives ---------------------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` stacked in rank order: (size, *x.shape)."""
        if self.group is None:
            return x[None]
        dist = torch.distributed
        wire = self._to_wire(x).reshape(-1)
        out = wire.new_empty((self.size * wire.numel(),))
        self._call("all_gather", dist.all_gather_into_tensor, out, wire)
        return self._from_wire(out, x).view((self.size,) + tuple(x.shape))

    def gather_cat(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order (the
        reference's ``all_gather(..., tiled=True)``)."""
        if self.group is None:
            return x
        out = self.all_gather(x)                       # (size, ..., c, ...)
        dim = dim % x.dim()
        out = out.movedim(0, dim)                      # (..., size, c, ...)
        shape = list(x.shape)
        shape[dim] *= self.size
        return out.reshape(shape)

    def sum_ordered(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over ranks of ``x``, added in rank order: the same bits on every
        rank, every backend and every run."""
        if self.group is None:
            return x
        parts = self.all_gather(x)
        acc = parts[0]
        for r in range(1, self.size):
            acc = acc + parts[r]
        return acc

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM.  Exact only where each element has one non-zero
        term across the ranks, which is the only way the engines use it."""
        if self.group is None:
            return x
        dist = torch.distributed
        wire = self._to_wire(x)
        if wire is x:
            wire = x.clone()
        self._call("all_reduce", dist.all_reduce, wire, op=dist.ReduceOp.SUM)
        return self._from_wire(wire, x)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """One ring hop: send ``x`` to rank − 1, receive rank + 1's.  Every
        rank must call it; ``hops`` counts the calls."""
        if self.group is None or self.size == 1:
            return x
        dist = torch.distributed
        wire = self._to_wire(x)
        recv = torch.empty_like(wire)
        peers = [self.ranks[(self.rank - 1) % self.size], self.ranks[(self.rank + 1) % self.size]]
        ops = [dist.P2POp(dist.isend, wire, peers[0], group=self.group),
               dist.P2POp(dist.irecv, recv, peers[1], group=self.group)]
        self.collectives += 1
        try:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        except RuntimeError as e:
            if is_host_loss(e):
                raise HostLossError(f"ring hop on the {self.size}-rank {self.axis!r} mesh "
                                    f"failed: a peer is dead or unreachable ({e})") from e
            raise
        self.hops += 1
        return self._from_wire(recv, x)


#: (group size, axis, the default group) -> (the default group, mesh)
_MESHES: dict[tuple, tuple] = {}


def selection_mesh(n_devices: int | None = None, *, axis: str = SELECTION_AXIS) -> SelectionMesh:
    """1-D mesh of ranks for sharding the selection ground-set row axis.

    ``n_devices`` keeps a prefix of the default group's ranks (every rank
    must make the same call: a prefix shorter than the world is a new
    group, and ``new_group`` is collective); the default uses every rank.
    Without an initialised process group the mesh has one member, this
    process, and ``n_devices`` must be 1 or None.  Meshes are cached per
    (default group, size, axis), so the same call returns the same object.
    """
    dist = _dist()
    world = dist.get_world_size() if dist is not None else 1
    if n_devices is not None and not 1 <= n_devices <= world:
        raise ValueError(f"n_devices={n_devices} out of range [1, {world}]")
    n = world if n_devices is None else int(n_devices)
    world_group = None if dist is None else dist.group.WORLD
    key = (n, axis, id(world_group))
    cached = _MESHES.get(key)
    if cached is not None and cached[0] is world_group:
        return cached[1]
    if dist is None:
        mesh = SelectionMesh(None, (0,), 0, axis=axis)
    else:
        me = dist.get_rank()
        group = world_group if n == world else dist.new_group(list(range(n)))
        mesh = SelectionMesh(group, tuple(range(n)), me if me < n else -1, axis=axis,
                             device=multihost.local_device(),
                             backend=dist.get_backend(world_group))
    _MESHES[key] = (world_group, mesh)
    return mesh


# --------------------------------------------------------------------------
# the LM rules: logical axes -> mesh axes, divisibility-aware
# --------------------------------------------------------------------------

def _sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes.get(a, 1) for a in axis)
    return sizes.get(axis, 1)


def maybe(mesh, dim_size: int, axis):
    """``axis`` (the part of it present in the mesh) if the mesh has it and
    it divides ``dim_size`` evenly, else None."""
    names = tuple(mesh.mesh_dim_names)
    if isinstance(axis, (tuple, list)):
        axis = tuple(a for a in axis if a in names)
        if not axis:
            return None
    elif axis is not None and axis not in names:
        return None
    return axis if dim_size % _axis_size(mesh, axis) == 0 else None


def placements(mesh, spec) -> tuple:
    """A spec (one entry per tensor dim: a mesh axis, a tuple of axes in
    the mesh's order, or None) as DTensor placements, one per mesh dim: a
    mesh dim that shards tensor dim ``d`` is ``Shard(d)``, one that shards
    nothing (or an axis of size 1, which splits nothing) ``Replicate()``.
    A tuple entry splits its dim over its axes major to minor, as a
    ``PartitionSpec`` does."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    taken: set[int] = set()
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's order {names}")
        for i in idx:
            if i in taken:
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of spec {spec}")
            taken.add(i)
            if sizes[i] > 1:  # an axis of one rank splits nothing: it stays Replicate()
                out[i] = Shard(d)
    return tuple(out)


_NORMS = ("norm1", "norm2", "norm", "final_norm", "a_log", "dt_bias")


def _leaf_spec(mesh, path: str, shape: tuple[int, ...]) -> tuple:
    """The reference's rule for one parameter leaf, keyed by its tree path.
    ``shape`` is the port's tensor: a group-stacked leaf's per-group
    tensor, so no leading stack axis (the reference prepends ``None``).

      embed (V, D)            -> (model, data)
      attention wq (D, H, K)  -> (data, model, None)
      attention wk/wv         -> (data, model?, None)   (kv heads often < TP)
      attention wo (H, K, D)  -> (model, None, data)
      mlp w_gate/w_up (D, F)  -> (data, model)
      mlp w_down (F, D)       -> (model, data)
      moe experts (E, D, F)   -> (model, data, None) / w_down (E, F, D)
      ssm w_in (D, E2)        -> (data, model) etc.
      norms / biases / gates  -> replicated
    """
    nd = len(shape)

    def spec(*axes):
        return tuple(maybe(mesh, shape[i], a) for i, a in enumerate(axes))

    if path.endswith("embed"):
        return spec("model", "data")
    name = path.rsplit("/", 1)[-1]
    if name in _NORMS:
        return (None,) * nd
    if name in ("wq", "wk", "wv"):
        return spec("data", "model", None) if nd == 3 else spec("data", "model")
    if name == "wo" and nd == 3:
        return spec("model", None, "data")
    if name == "router":
        return spec("data", None)
    if name in ("w_gate", "w_up"):
        return spec("model", "data", None) if nd == 3 else spec("data", "model")
    if name == "w_down":
        return spec("model", None, "data") if nd == 3 else spec("model", "data")
    if name in ("w_in", "w_bc", "w_z", "w_i", "w_f", "w_o", "w_dt"):
        return spec("data", "model")
    if name == "w_out":
        return spec("model", "data")
    if name in ("w_fgate", "w_igate"):
        return spec("data", None)
    return (None,) * nd


def param_shardings(mesh, params: Any) -> Any:
    """The placements of every parameter: a tree of ``params``' structure
    whose leaves are placement tuples (a ``Stacked`` leaf gives a list, one
    tuple per group)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(placements(mesh, _leaf_spec(mesh, path, tuple(t.shape)))
                              for t in node)
        return placements(mesh, _leaf_spec(mesh, path, tuple(node.shape)))

    return walk(params, "")


def distribute(mesh, tree: Any, shardings: Any) -> Any:
    """The tensors of ``tree`` as DTensors on ``mesh``, each laid out by its
    placement tuple in ``shardings`` (a tree of ``tree``'s structure, as
    ``param_shardings`` gives it).  Every rank passes the same full tensors
    and keeps its own shards of them: nothing is communicated."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, list(shardings), src_data_rank=None)
    if isinstance(tree, dict):
        return {k: distribute(mesh, v, shardings[k]) for k, v in tree.items()}
    parts = [distribute(mesh, v, s) for v, s in zip(tree, shardings)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


# --------------------------------------------------------------------------
# activations and inputs
# --------------------------------------------------------------------------

def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the batch dim: ('pod', 'data') when pod exists."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def batch_entry(mesh, batch: int):
    """The spec entry of a batch dim of ``batch`` rows: ``batch_axes`` if
    they divide it, else ``data`` if it does, else None."""
    axes = batch_axes(mesh)
    if batch % _axis_size(mesh, axes) == 0:
        return axes
    return "data" if batch % _axis_size(mesh, "data") == 0 else None


def data_spec(mesh, batch: int, extra_dims: int) -> tuple:
    """Placements of a (batch, ...) input with ``extra_dims`` more dims:
    the batch over ``batch_axes``, else over ``data``, else replicated."""
    return placements(mesh, (batch_entry(mesh, batch),) + (None,) * extra_dims)


def cache_spec(mesh, batch: int, seq: int, heads: int) -> tuple:
    """KV cache (B, S, H, D): the batch if it divides, else the sequence
    over ``data`` (sequence parallelism: long-context decode with a tiny
    batch); heads over ``model``."""
    axes = batch_axes(mesh)
    h = maybe(mesh, heads, "model")
    if batch % _axis_size(mesh, axes) == 0:
        return placements(mesh, (axes, None, h, None))
    if batch % _axis_size(mesh, "data") == 0 and _axis_size(mesh, "data") > 1 and batch > 1:
        return placements(mesh, ("data", None, h, None))
    return placements(mesh, (None, maybe(mesh, seq, "data"), h, None))


def ssm_state_spec(mesh, batch: int, heads: int) -> tuple:
    """SSM state (B, H, N, P): the batch over ``batch_axes`` if it divides;
    heads over ``model``."""
    axes = batch_axes(mesh)
    b = axes if batch % _axis_size(mesh, axes) == 0 else None
    return placements(mesh, (b, maybe(mesh, heads, "model"), None, None))


# --------------------------------------------------------------------------
# lookups along a vocabulary split (the embedding, the label's logit)
# --------------------------------------------------------------------------

def lookup_rows(table: DTensor, idx: torch.Tensor) -> DTensor:
    """``table[idx]`` for a (V, D) DTensor table, on each rank's local
    shard: the embedding's rows gathered whole (FSDP's gather on use), a
    split of the vocabulary kept, so each rank looks up the rows it holds
    and the others' come as zeros of a pending sum (the vocabulary-parallel
    embedding).  ``idx`` (plain or DTensor) keeps its batch split (dim 0)
    where the vocabulary is whole."""
    mesh = table.device_mesh
    tp = _shards.keep(table.placements, (0,))
    idx = _shards.as_dtensor(idx, mesh)
    ip = [Shard(0) if p == Shard(0) and tp[i] != Shard(0) else Replicate()
          for i, p in enumerate(idx.placements)]
    # a rank's gradient of the table covers only its own rows of idx: a
    # pending sum over the mesh dims that split idx
    tg = [Partial() if ip[i] == Shard(0) else p for i, p in enumerate(tp)]
    tl = table.redistribute(mesh, tp).to_local(grad_placements=tg)
    il = idx.redistribute(mesh, ip).to_local()
    if any(p == Shard(0) for p in tp):
        v0, n = _shards.offset(mesh, tp, 0, table.shape[0]), tl.shape[0]
        hit = (il >= v0) & (il < v0 + n)
        out = tl[(il - v0).clamp(0, n - 1)] * hit[..., None].to(tl.dtype)
    else:
        out = tl[il]
    pls = [Partial() if tp[i] == Shard(0) else p for i, p in enumerate(ip)]
    return DTensor.from_local(out, mesh, pls, run_check=False)


def take_last(x: DTensor, idx: torch.Tensor) -> DTensor:
    """``x.gather(-1, idx[..., None])[..., 0]`` for a DTensor ``x`` (B, ...,
    V) split over its vocabulary (the label's logit), on each rank's local
    shard: x's batch (dim 0) and vocabulary splits kept, ``idx`` split as
    x's batch; each rank takes the entries it holds and the others come as
    zeros of a pending sum."""
    mesh = x.device_mesh
    v = x.ndim - 1
    xp = _shards.keep(x.placements, (0, v))
    ip = _shards.follow(xp, {0: 0})
    xl = x.redistribute(mesh, xp).to_local()
    il = _shards.as_dtensor(idx, mesh).redistribute(mesh, ip).to_local().long()
    v0, n = _shards.offset(mesh, xp, v, x.shape[v]), xl.shape[-1]
    out = xl.gather(-1, (il - v0).clamp(0, n - 1)[..., None])[..., 0]
    if any(p == Shard(v) for p in xp):
        out = out * ((il >= v0) & (il < v0 + n)).to(out.dtype)
    pls = [Partial() if p == Shard(v) else q for p, q in zip(xp, ip)]
    return DTensor.from_local(out, mesh, pls, run_check=False)


# --------------------------------------------------------------------------
# in-model activation constraints against the ambient mesh
# --------------------------------------------------------------------------

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def ambient_mesh():
    """The mesh entered with ``use_mesh`` in this thread (context), or None."""
    return _AMBIENT.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` ambient for the models' ``constrain`` calls in this
    thread (the reference's ``with mesh:``).  Inside, a plain tensor that
    meets a DTensor in an op (positions, masks, constants the models make)
    counts as replicated: every rank makes the same one."""
    token = _AMBIENT.set(mesh)
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield mesh
    finally:
        dispatcher._allow_implicit_replication = before
        _AMBIENT.reset(token)


def constrain(x, *dim_axes):
    """Lay ``x`` out as the reference's ``with_sharding_constraint`` does.

    ``dim_axes``: one entry per dim — "batch" (pod+data), a mesh axis name
    (or a tuple of them), or None; an axis that does not divide its dim is
    dropped.  A DTensor
    under an ambient mesh is redistributed to that layout (the
    Megatron/FSDP activation layout: the batch stays split, so no rank
    computes another's rows); anything else is returned as it is, the same
    object.
    """
    mesh = _AMBIENT.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(dim_axes) != x.ndim:
        raise ValueError(f"{len(dim_axes)} axes for a tensor of shape {tuple(x.shape)}")
    spec = [batch_entry(mesh, dim) if ax == "batch" else maybe(mesh, dim, ax)
            for dim, ax in zip(x.shape, dim_axes)]
    return _Constrain.apply(x, placements(mesh, spec))


class _Constrain(torch.autograd.Function):
    """The layout pin of ``constrain``, forward and backward: the output is
    laid out as asked, and so is its gradient (the transpose of
    ``with_sharding_constraint`` constrains the cotangent alike), whatever
    layout the ops after it chose for theirs."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x) if tuple(x.placements) == want else x.redistribute(
            x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None
