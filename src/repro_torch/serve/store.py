"""Versioned artifact store: the server-side home of ``MiloMetadata`` (port
of ``repro.serve.store``: the same keys, file names and lockfiles, so one
store root may be shared by processes of either package).

MILO's economics rest on computing a preprocessing artifact ONCE per
(dataset, config) and serving it to arbitrarily many downstream trainings.
``ArtifactStore`` makes that a property of a long-lived process instead of a
file path convention:

  * **Keying** — artifacts are addressed by ``(data_fingerprint,
    config_hash)``: the content hash of the feature matrix and the canonical
    hash of the preprocessing config (``core.metadata.config_hash``).
    Same data + same config → same key → one artifact, however many clients
    ask.
  * **Single-flight builds** — concurrent requests for a missing key block
    on one per-key build lock; exactly one preprocessing run happens and
    every waiter receives its result.  A build that RAISES releases the
    flight lock on unwind and installs nothing — the next caller simply
    rebuilds — so one bad build can never wedge a key.  ``builds`` /
    ``build_failures`` / ``hits`` / ``disk_loads`` counters make both
    claims testable.
  * **Cross-process single-flight** — with a disk root, the build section
    is additionally guarded by an ``O_EXCL`` lockfile next to the artifact
    (``<artifact>.npz.lock`` recording the holder's PID), so N *processes*
    sharing one store root (the multi-host deployment shape) also build a
    key exactly once: the losers poll, and the moment the winner's atomic
    rename lands they load the finished artifact from disk.  A lockfile
    whose recorded PID is dead is taken over — the taker renames it to a
    tombstone (exactly one racing taker wins the ``rename``) and retries —
    so a SIGKILLed builder can never wedge the key for its peers.  A
    stuck-but-ALIVE holder only stalls waiters until ``lock_timeout``,
    after which they build redundantly rather than hang (the artifact
    write is an atomic rename, so the race costs duplicate work, never a
    torn file).  ``lock_waits`` / ``lock_steals`` / ``lock_timeouts``
    counters expose each path.
  * **Two tiers** — an in-memory LRU of decoded ``MiloMetadata`` objects in
    front of an optional on-disk root (one ``.npz`` per key, written through
    ``MiloMetadata.save``'s atomic temp-file rename).  Evicting a memory
    entry keeps the disk copy; the next request reloads it through the
    reuse guards (config-hash verification), bit-identical to the original.
  * **Pinning** — pinned keys are exempt from LRU eviction (for tenants with
    a latency SLO on a known dataset).
  * **Versioning** — each rebuild of a key (``force=True``) bumps a
    monotonically increasing per-key version, recorded in the entry and the
    request log, so a client can tell whether two responses came from the
    same artifact generation.

The store never invents artifacts: a disk file whose stored config hash does
not match the requested config raises ``MetadataMismatchError`` (the same
guard ``MiloSession`` applies to ``metadata_path`` artifacts).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Any, Callable

from repro_torch.core.metadata import (
    MetadataMismatchError,
    MiloMetadata,
    config_hash,
)

#: (data_fingerprint, config_hash)
ArtifactKey = tuple[str, str]


def _pid_alive(pid: int) -> bool:
    """Whether ``pid`` names a live process (signal-0 probe)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


@dataclasses.dataclass
class ArtifactEntry:
    """Bookkeeping for one stored artifact (metadata may be evicted)."""

    key: ArtifactKey
    version: int
    pinned: bool = False
    hits: int = 0
    path: str | None = None


class ArtifactStore:
    """In-memory LRU + on-disk artifact store with single-flight builds."""

    def __init__(
        self,
        root: str | None = None,
        *,
        capacity: int = 8,
        lock_timeout: float = 300.0,
        lock_poll: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.root = root
        self.capacity = capacity
        # cross-process lockfile knobs (root-backed stores only); clock and
        # sleep are injectable so the timeout paths are testable without
        # real waiting
        self.lock_timeout = lock_timeout
        self.lock_poll = lock_poll
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        # insertion order == recency order (move_to_end on every touch)
        self._memory: collections.OrderedDict[ArtifactKey, MiloMetadata] = (
            collections.OrderedDict()
        )
        self._entries: dict[ArtifactKey, ArtifactEntry] = {}
        self._flights: dict[ArtifactKey, threading.Lock] = {}
        #: consecutive build failures per key (reset by a successful build);
        #: the observable MiloServer's circuit breaker trips on
        self._key_failures: dict[ArtifactKey, int] = {}
        self.builds = 0
        self.build_failures = 0
        self.hits = 0
        self.disk_loads = 0
        self.evictions = 0
        self.lock_waits = 0
        self.lock_steals = 0
        self.lock_timeouts = 0
        if root:
            os.makedirs(root, exist_ok=True)

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def key_for(data_fingerprint: str, config: dict[str, Any]) -> ArtifactKey:
        """The store key for a (dataset, preprocessing-config) pair."""
        return (data_fingerprint, config_hash(config))

    def path_for(self, key: ArtifactKey) -> str | None:
        if self.root is None:
            return None
        return os.path.join(self.root, f"{key[0]}_{key[1]}.npz")

    # -- pin policy ---------------------------------------------------------

    def pin(self, key: ArtifactKey) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                raise KeyError(f"unknown artifact key {key}")
            entry.pinned = True

    def unpin(self, key: ArtifactKey) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.pinned = False

    # -- lookup / build -----------------------------------------------------

    def get_or_build(
        self,
        key: ArtifactKey,
        expected_config: dict[str, Any],
        build_fn: Callable[[], MiloMetadata],
        *,
        pin: bool = False,
        force: bool = False,
    ) -> tuple[MiloMetadata, ArtifactEntry, str]:
        """Return ``(artifact, entry, source)`` for ``key``, building at most
        once; ``source`` is ``"memory"`` / ``"disk"`` / ``"built"`` (the
        request-log observable behind a warm/cold split).

        Resolution order: in-memory hit → on-disk reload (verified against
        ``expected_config`` through the ``MiloMetadata.load`` reuse guards)
        → ``build_fn()`` (exactly one concurrent caller runs it; the rest
        wait on the per-key flight lock and hit the fresh entry).
        ``force=True`` skips both caches, reruns ``build_fn`` and bumps the
        key's version.
        """
        flight = self._flight(key)
        with flight:
            if not force:
                cached = self._memory_hit(key)
                if cached is not None:
                    if pin:
                        cached[1].pinned = True
                    return (*cached, "memory")
                loaded = self._disk_load(key, expected_config)
                if loaded is not None:
                    if pin:
                        loaded[1].pinned = True
                    return (*loaded, "disk")
            path = self.path_for(key)
            lock_path = None
            if path is not None and not force:
                # cross-process single-flight: win the O_EXCL lockfile or
                # wait for the winning process's artifact to land on disk
                lock_path, loaded = self._acquire_build_lock(
                    key, path, expected_config
                )
                if loaded is not None:
                    if pin:
                        loaded[1].pinned = True
                    return (*loaded, "disk")
            try:
                try:
                    md = build_fn()
                except BaseException:
                    # a failed build must not poison the key: count it, let
                    # the ``with flight:`` release the per-key lock on
                    # unwind, and leave no partial entry behind.  Each
                    # waiter blocked on the flight lock then resolves the
                    # key itself (cache miss → its own build attempt)
                    # instead of hanging forever on a lock the dead builder
                    # never released.
                    with self._lock:
                        self.build_failures += 1
                        self._key_failures[key] = (
                            self._key_failures.get(key, 0) + 1
                        )
                    raise
                with self._lock:
                    self.builds += 1
                    self._key_failures.pop(key, None)
                    entry = self._entries.get(key)
                    if entry is None:
                        entry = ArtifactEntry(key=key, version=1,
                                              path=self.path_for(key))
                        self._entries[key] = entry
                    else:
                        entry.version += 1
                    entry.pinned = entry.pinned or pin
                if path is not None:
                    md.save(path)
            finally:
                # released AFTER the atomic save, so a waiter that sees the
                # lock vanish also sees the finished artifact
                if lock_path is not None:
                    self._release_build_lock(lock_path)
            self._install(key, md)
            return md, self._entries[key], "built"

    # -- cross-process lockfile ---------------------------------------------

    def _acquire_build_lock(
        self, key: ArtifactKey, path: str, expected_config: dict[str, Any]
    ) -> tuple[str | None, tuple[MiloMetadata, ArtifactEntry] | None]:
        """Win the key's cross-process build lock, or load the peer's result.

        Returns ``(lock_path, None)`` once this process owns the lockfile
        (build may proceed; the caller must ``_release_build_lock``), or
        ``(None, (md, entry))`` when another process finished the build
        first and its artifact was loaded from disk.  On ``lock_timeout``
        returns ``(None, None)``: the caller builds WITHOUT the lock —
        ``MiloMetadata.save`` is an atomic rename, so a stuck-but-alive
        holder costs duplicated work, never a torn artifact.
        """
        lock_path = path + ".lock"
        deadline = self._clock() + self.lock_timeout
        waited = False
        while True:
            if self._try_lock(lock_path):
                return lock_path, None
            if not waited:
                waited = True
                with self._lock:
                    self.lock_waits += 1
            if os.path.exists(path):
                loaded = self._disk_load(key, expected_config)
                if loaded is not None:
                    return None, loaded
            if self._clock() >= deadline:
                with self._lock:
                    self.lock_timeouts += 1
                return None, None
            self._sleep(self.lock_poll)

    def _try_lock(self, lock_path: str) -> bool:
        """One O_EXCL attempt; reaps a dead holder's lock as a side effect."""
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self._reap_stale_lock(lock_path)
            return False
        try:
            os.write(fd, str(os.getpid()).encode("ascii"))
        finally:
            os.close(fd)
        return True

    def _reap_stale_lock(self, lock_path: str) -> None:
        """Remove ``lock_path`` if its recorded holder PID is dead.

        The takeover is race-free: every contender renames the lock to its
        OWN tombstone name first, and ``os.rename`` lets exactly one win;
        the losers' renames fail and they simply retry the O_EXCL open
        (now against the new holder's lock).
        """
        try:
            with open(lock_path, encoding="ascii") as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            # vanished under us, or the holder hasn't recorded its PID yet
            # (microsecond window after its O_EXCL open): treat as live
            return
        if _pid_alive(pid):
            return
        tombstone = f"{lock_path}.stale.{os.getpid()}"
        try:
            os.rename(lock_path, tombstone)
        except OSError:
            return  # a racing reaper won the rename
        try:
            os.unlink(tombstone)
        except OSError:
            pass
        with self._lock:
            self.lock_steals += 1

    def _release_build_lock(self, lock_path: str) -> None:
        try:
            os.unlink(lock_path)
        except OSError:
            pass

    def _flight(self, key: ArtifactKey) -> threading.Lock:
        with self._lock:
            return self._flights.setdefault(key, threading.Lock())

    def _memory_hit(self, key: ArtifactKey) -> tuple[MiloMetadata, ArtifactEntry] | None:
        with self._lock:
            md = self._memory.get(key)
            if md is None:
                return None
            self._memory.move_to_end(key)
            entry = self._entries[key]
            entry.hits += 1
            self.hits += 1
            return md, entry

    def _disk_load(
        self, key: ArtifactKey, expected_config: dict[str, Any]
    ) -> tuple[MiloMetadata, ArtifactEntry] | None:
        path = self.path_for(key)
        if path is None or not os.path.exists(path):
            return None
        # the reuse guards (same semantics as MiloSession's metadata_path
        # load): the stored config must agree with the request's on every
        # key the request specifies — partial-dict check, because the
        # artifact records MORE than the request config (encoder, seeds,
        # engine provenance) and key[1] hashes only the request's view —
        # and a recorded data fingerprint must match the key's.  A foreign
        # file parked at this key's path fails one of the two.
        md = MiloMetadata.load(path, expected_config=expected_config or None)
        stored_fp = md.config.get("data_fingerprint")
        if stored_fp is not None and stored_fp != key[0]:
            raise MetadataMismatchError(
                f"{path}: artifact was preprocessed over different data "
                f"(fingerprint {stored_fp} != requested {key[0]})"
            )
        with self._lock:
            self.disk_loads += 1
            entry = self._entries.get(key)
            if entry is None:
                # artifact predates this process (written by an earlier
                # server); adopt it at version 1
                entry = ArtifactEntry(key=key, version=1, path=path)
                self._entries[key] = entry
            entry.hits += 1
        self._install(key, md)
        return md, self._entries[key]

    def _install(self, key: ArtifactKey, md: MiloMetadata) -> None:
        """Insert into the memory tier, evicting LRU unpinned entries."""
        with self._lock:
            self._memory[key] = md
            self._memory.move_to_end(key)
            evictable = [
                k for k in self._memory
                if k != key and not self._entries[k].pinned
            ]
            # oldest first (OrderedDict preserves recency order)
            while len(self._memory) > self.capacity and evictable:
                victim = evictable.pop(0)
                del self._memory[victim]
                self.evictions += 1

    # -- introspection ------------------------------------------------------

    def resident(self, key: ArtifactKey) -> bool:
        """Whether the decoded artifact currently sits in the memory tier."""
        with self._lock:
            return key in self._memory

    def failures_for(self, key: ArtifactKey) -> int:
        """Consecutive build failures for ``key`` since its last success."""
        with self._lock:
            return self._key_failures.get(key, 0)

    def entries(self) -> list[ArtifactEntry]:
        with self._lock:
            return [dataclasses.replace(e) for e in self._entries.values()]

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "builds": self.builds,
                "build_failures": self.build_failures,
                "failing_keys": len(self._key_failures),
                "hits": self.hits,
                "disk_loads": self.disk_loads,
                "evictions": self.evictions,
                "lock_waits": self.lock_waits,
                "lock_steals": self.lock_steals,
                "lock_timeouts": self.lock_timeouts,
                "resident": len(self._memory),
                "known": len(self._entries),
            }
