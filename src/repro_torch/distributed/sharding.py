"""The selection mesh: the ground-set row axis over the ranks of a
``torch.distributed`` process group (port of ``SELECTION_AXIS`` and
``selection_mesh`` of ``repro.distributed.sharding``).

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

import torch

from repro_torch.distributed import multihost
from repro_torch.distributed.fault_tolerance import HostLossError

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
