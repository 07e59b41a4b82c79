"""Multi-host runtime: start-up, coordination barriers, host liveness
(port of ``repro.distributed.multihost``).

  * ``initialize()`` — an idempotent, env-driven start of
    ``torch.distributed``.  It reads the reference's env triplet
    (``MILO_COORDINATOR`` / ``MILO_NUM_PROCESSES`` / ``MILO_PROCESS_ID``),
    builds a ``TCPStore`` at the coordinator (rank 0 hosts it) and calls
    ``init_process_group(store=..., timeout=...)``.  Launch N processes
    with::

        MILO_COORDINATOR=localhost:<port> MILO_NUM_PROCESSES=N \
            MILO_PROCESS_ID=<i> python ...

    The backend is ``nccl`` when each rank of this host has a card of its
    own and ``gloo`` otherwise (the CPU, or ranks that share a card); the
    caller may name it, and ``nccl`` for ranks that share a card raises
    (NCCL refuses two ranks on one GPU).  ``LOCAL_WORLD_SIZE`` /
    ``LOCAL_RANK`` say how many ranks share this host and which one this
    is; without them every rank posts its host name to the store and
    counts the ranks that share its own (``local_layout``).
  * ``RuntimeBarrier`` — a named barrier over the store (a counter key and
    a deadline, no device collective).  A timeout means a peer did not
    arrive — the canonical dead-host signal — and raises ``HostLossError``.
  * ``FileBarrier`` — the same contract over marker files, for in-process
    *simulated* multi-host tests (two ``CheckpointManager``s on threads).
    Marker names must be unique per rendezvous (the checkpointer's embed
    the step).
  * ``HeartbeatWriter`` / ``HeartbeatMonitor`` — host liveness as atomic
    JSON files on shared storage (the reference's format, so either
    package's monitor reads the other's beacons), with an injectable clock;
    ``check()`` raises ``HostLossError`` naming the stale hosts.
  * ``global_put`` — this rank's part of a host-replicated tensor on a
    selection mesh: each rank slices its own rows from its own full copy,
    so placement moves no bytes between processes.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import json
import os
import re
import socket
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import HostLossError

_HOST_RE = re.compile(r"^host_(\d+)\.json$")

#: what ``initialize()`` set up in this process
_STATE: dict[str, Any] = {"store": None, "backend": None, "device": None, "timeout": None,
                          "lost": False, "barriers": {}}


def _dist():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def _lost(err: HostLossError) -> HostLossError:
    """Record that this process saw a peer die (its exit then waits for no
    one) and hand the error back to raise."""
    _STATE["lost"] = True
    return err


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def is_initialized() -> bool:
    """Whether ``torch.distributed`` has a process group in this process."""
    return _dist() is not None


def choose_backend(backend: str | None, local_processes: int) -> str:
    """``nccl`` when each of this host's ``local_processes`` ranks has a card
    of its own, else ``gloo``; a named backend is checked, never swapped."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    own_card = 0 < local_processes <= cards
    if backend is None:
        return "nccl" if own_card else "gloo"
    if backend == "nccl" and not own_card:
        raise ValueError(
            f"backend='nccl' needs a card per rank, but {local_processes} ranks share "
            f"{cards} card(s) on this host (NCCL refuses two ranks on one GPU); use "
            "backend='gloo' or one process per card")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; one of ('nccl', 'gloo')")
    return backend


def local_device() -> torch.device:
    """The device this rank computes on, as ``initialize`` resolved it (its
    own card under NCCL, a card shared round-robin under gloo, or the CPU
    when the caller asked for it); without ``initialize``, the current card,
    and without a card this raises: the port never picks the CPU on its
    own."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    return resolve_device("cuda")


def local_layout(store, process_id: int, num_processes: int, *, host: str | None = None,
                 timeout: float = 120.0) -> tuple[int, int]:
    """(ranks on this host, this rank's index among them), from the store:
    every rank posts its host name (default ``socket.gethostname()``), waits
    for all ``num_processes`` posts and counts the ranks that name the same
    host, its local index being its order among them by process id."""
    host = socket.gethostname() if host is None else host
    store.set(f"milo/host/{process_id}", host)
    keys = [f"milo/host/{r}" for r in range(num_processes)]
    try:
        store.wait(keys, datetime.timedelta(seconds=float(timeout)))
    except RuntimeError as e:
        raise _lost(HostLossError(
            f"not every one of {num_processes} processes posted its host within "
            f"{timeout}s ({e})")) from e
    same = [r for r in range(num_processes) if store.get(keys[r]).decode() == host]
    return len(same), same.index(process_id)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout: float = 120.0,
    device: str | torch.device = "cuda",
) -> bool:
    """Idempotent ``torch.distributed`` start with env-driven defaults.

    Reads ``MILO_COORDINATOR`` / ``MILO_NUM_PROCESSES`` / ``MILO_PROCESS_ID``
    when arguments are omitted; a no-op (returns False) when neither
    arguments nor env vars ask for multi-process execution, or when a
    process group already exists.  ``timeout`` (s) bounds the store, every
    barrier's default and every collective: a peer that died makes the
    survivors raise within it instead of hanging (under NCCL,
    ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` is set for that).

    ``device`` is resolved before the store is created: ``"cuda"`` (the
    default) raises without a card, and each rank then takes card
    ``local_rank % device_count``; ``"cpu"`` runs the ranks on the CPU over
    gloo.
    """
    if is_initialized():
        return False
    coordinator_address = coordinator_address or os.environ.get("MILO_COORDINATOR")
    if num_processes is None:
        env_n = os.environ.get("MILO_NUM_PROCESSES")
        num_processes = int(env_n) if env_n else None
    if process_id is None:
        env_i = os.environ.get("MILO_PROCESS_ID")
        process_id = int(env_i) if env_i else None
    if coordinator_address is None or num_processes is None or num_processes < 2:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} out of range [0, {num_processes})")
    device = resolve_device(device)
    if device.type == "cpu" and backend not in (None, "gloo"):
        raise ValueError(f"device='cpu' runs on gloo; backend={backend!r} cannot")
    dist = torch.distributed
    host, port = coordinator_address.rsplit(":", 1)
    td = datetime.timedelta(seconds=float(timeout))
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=td)
    if os.environ.get("LOCAL_WORLD_SIZE"):
        local_n = int(os.environ["LOCAL_WORLD_SIZE"])
        local_i = int(os.environ.get("LOCAL_RANK") or process_id)
    else:
        local_n, local_i = local_layout(store, process_id, num_processes, timeout=timeout)
    if device.type == "cuda":
        backend = choose_backend(backend, local_n)
        device = torch.device("cuda", local_i % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=td)
    _STATE.update(store=store, backend=backend, device=device, timeout=float(timeout),
                  lost=False, barriers={})
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """End this process's part of the job (registered at ``initialize``).

    Rank 0 hosts the store, so it waits (bounded by the timeout) until every
    rank has reached its own shutdown before tearing the group down; a
    process that saw a peer die waits for no one."""
    dist = _dist()
    store = _STATE["store"]
    if dist is None or store is None:
        return
    try:
        if not _STATE["lost"]:
            n = store.add("milo/shutdown", 1)
            if process_index() == 0:
                deadline = time.monotonic() + min(_STATE["timeout"] or 30.0, 30.0)
                while n < process_count() and time.monotonic() < deadline:
                    time.sleep(0.01)
                    n = store.add("milo/shutdown", 0)
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - a peer already gone: nothing left to end
        pass
    finally:
        _STATE.update(store=None, backend=None, device=None)


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def is_coordinator() -> bool:
    """Process 0 coordinates: it publishes global checkpoint manifests and
    owns garbage collection.  Single-process runs are their own coordinator."""
    return process_index() == 0


# ---------------------------------------------------------------------------
# barriers
# ---------------------------------------------------------------------------

class RuntimeBarrier:
    """Named barrier over the ``initialize()`` store.

    ``wait(name)`` blocks until every process has called ``wait`` with the
    same name (the n-th wait on a name meets the others' n-th); a peer that
    does not arrive within ``timeout`` — the canonical "a peer died"
    observable — raises ``HostLossError``, as does a store whose host (rank
    0) is gone.  Requires ``initialize()`` to have run.
    """

    def __init__(self, timeout: float = 120.0):
        self.timeout = float(timeout)

    def wait(self, name: str) -> None:
        store = _STATE["store"]
        if store is None:
            raise RuntimeError("RuntimeBarrier requires torch.distributed to be initialized "
                               "(multihost.initialize())")
        gens = _STATE["barriers"]
        gen = gens.get(name, 0)
        gens[name] = gen + 1
        key = f"milo/barrier/{name}/{gen}"
        world = process_count()
        try:
            if store.add(key + "/count", 1) >= world:
                store.set(key + "/done", "1")
            store.wait([key + "/done"], datetime.timedelta(seconds=self.timeout))
        except RuntimeError as e:
            raise _lost(HostLossError(
                f"barrier {name!r} not reached by all {world} hosts within "
                f"{self.timeout}s — a peer is unreachable or dead ({e})")) from e


@dataclasses.dataclass
class FileBarrier:
    """Marker-file barrier for in-process *simulated* multi-host tests.

    Each participant drops ``<root>/<name>.<index>`` and polls until all
    ``count`` markers exist.  Markers persist after the rendezvous, so every
    barrier name must be unique per logical rendezvous (the checkpointer's
    names embed the step number).  Real multi-process runs use
    ``RuntimeBarrier`` instead.
    """

    root: str
    index: int
    count: int
    timeout: float = 30.0
    poll: float = 0.005
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep

    def wait(self, name: str) -> None:
        os.makedirs(self.root, exist_ok=True)
        mine = os.path.join(self.root, f"{name}.{self.index}")
        with open(mine, "w") as f:
            f.write(str(self.index))
        deadline = self.clock() + self.timeout
        while True:
            missing = [
                i for i in range(self.count)
                if not os.path.exists(os.path.join(self.root, f"{name}.{i}"))
            ]
            if not missing:
                return
            if self.clock() > deadline:
                raise HostLossError(
                    f"barrier {name!r}: hosts {missing} absent after "
                    f"{self.timeout}s",
                    hosts=missing,
                )
            self.sleep(self.poll)


def default_barrier(timeout: float = 120.0) -> RuntimeBarrier | None:
    """The barrier real multi-process runs coordinate on (None when this is
    a plain single-process run with no process group)."""
    return RuntimeBarrier(timeout) if _STATE["store"] is not None else None


# ---------------------------------------------------------------------------
# host liveness: heartbeat files with an injectable clock
# ---------------------------------------------------------------------------

class HeartbeatWriter:
    """Writes this host's liveness beacon: ``<dir>/host_<i>.json``.

    Atomic (temp file + rename) so a monitor never parses a torn beat; NOT
    fsync'd — a heartbeat is a freshness signal, not durable state, and an
    fsync per training step would be a straggler generator.
    """

    def __init__(
        self,
        directory: str,
        proc_index: int | None = None,
        *,
        clock: Callable[[], float] = time.time,
    ):
        self.directory = directory
        self.index = process_index() if proc_index is None else int(proc_index)
        self.clock = clock
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"host_{self.index}.json")

    def beat(self, step: int | None = None) -> None:
        payload = {"process_index": self.index, "time": self.clock()}
        if step is not None:
            payload["step"] = int(step)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


class HeartbeatMonitor:
    """Reads every host's beacon and flags the stale/missing ones.

    ``expected`` hosts with no beacon file at all count as stale from the
    monitor's construction (age = now - created) — a host that never wrote a
    beat is indistinguishable from one that died before its first.  The
    injectable ``clock`` makes staleness a pure function of test inputs.
    """

    def __init__(
        self,
        directory: str,
        *,
        timeout: float = 60.0,
        expected: int | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.directory = directory
        self.timeout = float(timeout)
        self.expected = expected
        self.clock = clock
        self._created = clock()

    def _beats(self) -> dict[int, dict[str, Any]]:
        out: dict[int, dict[str, Any]] = {}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for fn in names:
            m = _HOST_RE.match(fn)
            if not m:
                continue
            try:
                with open(os.path.join(self.directory, fn)) as f:
                    out[int(m.group(1))] = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue  # mid-replace read: treat as absent this poll
        return out

    def ages(self) -> dict[int, float]:
        """Seconds since each known/expected host's last beat."""
        now = self.clock()
        beats = self._beats()
        hosts = set(beats)
        if self.expected is not None:
            hosts |= set(range(self.expected))
        return {
            i: (now - beats[i]["time"]) if i in beats else (now - self._created)
            for i in sorted(hosts)
        }

    def stale_hosts(self) -> list[int]:
        return [i for i, age in self.ages().items() if age > self.timeout]

    def check(self) -> None:
        """Raise ``HostLossError`` naming every stale host."""
        stale = self.stale_hosts()
        if stale:
            ages = self.ages()
            detail = ", ".join(f"host {i}: {ages[i]:.1f}s" for i in stale)
            raise _lost(HostLossError(
                f"host(s) {stale} stale past the {self.timeout}s heartbeat "
                f"timeout ({detail}) — re-mesh via elastic_plan and resume "
                "from the last globally-valid checkpoint",
                hosts=stale,
            ))

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe liveness summary for ``MiloServer.health()``."""
        ages = self.ages()
        stale = [i for i, age in ages.items() if age > self.timeout]
        return {
            "expected": self.expected,
            "timeout": self.timeout,
            "ages": {str(i): round(age, 3) for i, age in ages.items()},
            "stale": stale,
        }


# ---------------------------------------------------------------------------
# placement on a selection mesh
# ---------------------------------------------------------------------------

class RowShard(NamedTuple):
    """This rank's rows of a row-sharded (n, d) tensor: ``local`` holds rows
    ``[offset, offset + len(local))`` of the ``n`` global rows."""

    local: torch.Tensor
    n: int
    offset: int


def mesh_spans_processes(mesh) -> bool:
    """Whether the mesh's ranks live in more than one process (one rank a
    process in the port)."""
    return mesh.group is not None and mesh.size > 1


def global_put(x: torch.Tensor, mesh, spec: tuple = (None,)):
    """Place a host-replicated tensor on a selection mesh.

    Every process holds the full ``x`` (replicated host data is the contract
    for selection inputs), so placement moves no bytes between processes:
    ``spec = (mesh.axis, None)`` gives this rank's ``RowShard`` (rows
    ``rank·n/size`` onward, ``n`` divisible by the mesh); any other spec
    (replicated) gives ``x`` itself."""
    if not spec or spec[0] != mesh.axis:
        return x
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide the {mesh.size}-rank {mesh.axis!r} mesh")
    chunk = n // mesh.size
    off = max(mesh.rank, 0) * chunk
    return RowShard(x[off:off + chunk], n, off)
