"""Atomic, async, crash-safe checkpointing (port of
``repro.checkpoint.checkpointer``, the single-process format-2 protocol).

  * A checkpoint is a directory ``step_<N>/`` holding ``shard_0.npz`` plus
    a ``manifest.json`` (leaf shapes and dtypes, step, per-file sha256
    checksums and free-form ``extra`` run metadata), written LAST.
  * Writes go to ``step_<N>.tmp/``; the shard and the manifest are fsync'd
    before ``os.replace`` publishes the directory, and the parent directory
    is fsync'd after, so a crash can never publish a torn shard under a
    completed-looking name.  The shard's sha256 is computed on a helper
    thread from the bytes as they are written (its zip entries are
    streamed, each closed by a data descriptor, so no byte is rewritten
    after it was hashed); ``restore`` reads each entry straight from its
    offset.
  * ``validate_step`` replays the checksums (plus shard-count and
    manifest-parse checks) and raises ``CheckpointCorruptionError`` on any
    damage; ``latest_valid_step`` walks newest-first and returns the first
    checkpoint that passes.  ``restore`` validates by default.
  * ``save_async`` snapshots the tensors to host memory synchronously and
    writes on a background thread; ``wait()`` re-raises the worker's
    exception.  In-flight steps are registered before the thread starts and
    never garbage-collected, and the ``keep_last`` window counts them.

The files are the reference's: leaves are named as its ``_flatten`` names
them (``params/embed``, ``opt_state/m/...``, ``step``: NamedTuple fields,
dict keys, sequence indices), an LM's group-stacked leaves (``tree.Stacked``)
are stacked into the reference's one array, and bf16 leaves are stored as
the raw 2-byte payload under npy descr ``<V2`` with manifest dtype
``bfloat16`` — the bytes the reference's ``np.savez`` writes for
``ml_dtypes.bfloat16`` (no ``ml_dtypes`` here: the bits go through int16).
So a checkpoint written by either package validates and restores in the
other, leaf for leaf.  ``restore(step, target)`` puts every leaf on the
device of ``target``'s matching leaf.

**Multi-host (two-phase coordinated commit).**  With ``process_count > 1``
every host takes part in one distributed checkpoint per step, as in the
reference:

  1. *Rendezvous + staging*: all hosts meet at a named barrier, then the
     coordinator (process 0) alone resets ``step_<N>.tmp/`` and a second
     barrier releases the writers, so a crashed earlier attempt's stale
     staging can never mix with this one.
  2. *Phase 1 — local durability*: every host fsyncs its own
     ``shard_<i>.npz`` plus a host manifest ``host_<i>.json`` carrying its
     shard's checksum (atomic rename).
  3. *Phase 2 — validate + atomic publish*: the coordinator waits for every
     host manifest (a host that never delivers ⇒ ``HostLossError``),
     re-hashes every shard against its host's checksum, merges them into
     ONE global ``manifest.json`` (format 3, ``num_shards =
     process_count``), fsyncs it and renames the directory.  The others
     block until the publication appears (a coordinator that never
     publishes ⇒ ``HostLossError``).

  A crash of any host at any instant publishes a complete global checkpoint
  or nothing, and ``latest_valid_step`` skips a step missing (or holding a
  torn copy of) any host's shard on every host.  GC runs on the coordinator
  only.  Real multi-process runs meet at ``multihost.RuntimeBarrier`` (the
  store of ``multihost.initialize()``); in-process simulated tests inject a
  ``multihost.FileBarrier``.  Every wait is bounded by ``barrier_timeout``.
  Single-host checkpoints keep writing format 2, byte for byte as before.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed import multihost
from repro_torch.distributed.fault_tolerance import HostLossError
from repro_torch.tree import Stacked

_STEP_RE = re.compile(r"^step_(\d+)$")

#: manifest format carrying per-file checksums + extra run metadata
MANIFEST_FORMAT = 2

#: format 3 = a coordinator-published global manifest merging per-host
#: shard checksums (two-phase multi-host commit); single-host checkpoints
#: keep writing format 2
MULTIHOST_MANIFEST_FORMAT = 3

#: bytes per write call when streaming a leaf into the shard
_CHUNK = 64 << 20


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory exists but fails validation (torn shard,
    unparseable manifest, missing file, checksum mismatch)."""


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fsync_write(path: str, write_fn) -> None:
    """Write ``path`` through ``write_fn(file)`` and fsync it to disk."""
    with open(path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order and naming; a
    ``Stacked`` list is one leaf."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, Stacked)):
        return [("/".join(prefix) if prefix else "_root", tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f, v in zip(tree._fields, tree) for p in _flatten(v, prefix + (f,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in _flatten(v, prefix + (str(i),))]
    raise TypeError(f"a checkpointed tree holds tensors only, not {type(tree).__name__}")


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


class _HostLeaf:
    """A leaf's host copy: its raw array (bf16 as int16 bits) and the
    reference's dtype name."""

    def __init__(self, leaf: torch.Tensor | Stacked):
        parts = list(leaf) if isinstance(leaf, Stacked) else [leaf]
        first = parts[0]
        self.dtype = _dtype_name(first.dtype)
        raw_dtype = torch.int16 if first.dtype == torch.bfloat16 else first.dtype
        shape = ((len(parts),) if isinstance(leaf, Stacked) else ()) + tuple(first.shape)
        buf = torch.empty(shape, dtype=raw_dtype)
        for i, t in enumerate(parts):
            src = t.detach()
            if src.dtype == torch.bfloat16:
                src = src.view(torch.int16)
            (buf[i] if isinstance(leaf, Stacked) else buf).copy_(src)
        self.array = buf.numpy()

    @property
    def descr(self) -> str:
        if self.dtype == "bfloat16":
            return "<V2"
        return np.lib.format.dtype_to_descr(self.array.dtype)

    @property
    def nbytes(self) -> int:
        return self.array.nbytes


class _HashingWriter:
    """A forward-only file: every byte written also goes, in order, to a
    sha256 computed on a helper thread (hashing and writing overlap; both
    release the GIL).  It cannot seek, so ``zipfile`` streams each entry
    with a data descriptor instead of seeking back to patch its header:
    the bytes hashed are the file's bytes."""

    def __init__(self, f):
        import queue

        self._f, self._pos = f, 0
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._h = hashlib.sha256()
        self.hash_s = 0.0
        self._t = threading.Thread(target=self._hash, daemon=True)
        self._t.start()

    def _hash(self):
        while (b := self._q.get()) is not None:
            t0 = time.perf_counter()
            self._h.update(b)
            self.hash_s += time.perf_counter() - t0

    def write(self, b) -> int:
        n = self._f.write(b)
        self._q.put(b)
        self._pos += n
        return n

    def tell(self) -> int:
        return self._pos

    def seek(self, *args):
        raise OSError("forward-only")

    def flush(self) -> None:
        self._f.flush()

    def hexdigest(self) -> str:
        self._q.put(None)
        self._t.join()
        return self._h.hexdigest()


def _write_npz(f, names: list[str], leaves: list[_HostLeaf]) -> None:
    """``np.savez``'s entries (a stored zip, one npy per leaf, zip64), with
    bf16 leaves under descr ``<V2``; streamed entries on a forward-only
    file."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, leaf in zip(names, leaves):
            arr = leaf.array  # C-contiguous: a fresh host copy
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": leaf.descr, "fortran_order": False, "shape": arr.shape})
                raw = memoryview(arr.reshape(-1).view(np.uint8))
                for lo in range(0, len(raw), _CHUNK):
                    fid.write(raw[lo:lo + _CHUNK])


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """Every npy entry of a stored npz (as both packages write them), each
    read straight from its offset into its array (``np.fromfile``: no
    zip-stream copies; the file's sha256 is what vouches for the bytes)."""
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise CheckpointCorruptionError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            local = f.read(30)
            n_name, n_extra = int.from_bytes(local[26:28], "little"), \
                int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            count = int(np.prod(shape, dtype=np.int64))
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise CheckpointCorruptionError(f"{path}: {info.filename} is short")
            out[name] = arr.reshape(shape, order="F" if fortran else "C")
    return out


def _to_tensor(arr: np.ndarray, dtype_name: str | None, device: torch.device) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype_name == "bfloat16" or arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        keep_last: int = 3,
        process_index: int | None = None,
        process_count: int | None = None,
        barrier: Any | None = None,
        barrier_timeout: float = 120.0,
        poll_interval: float = 0.02,
    ):
        """``process_index``/``process_count`` default to ``torch.distributed``'s
        rank and world size (``multihost``), else 0 and 1 (overridable so the
        two-phase protocol is testable in one process); ``barrier`` is any
        object with ``wait(name)`` and defaults to ``multihost.default_barrier``
        when a process group is live.  ``barrier_timeout`` bounds every wait a
        dead peer could hang: barriers, the coordinator's host-manifest
        collection and the others' publication poll — each raises
        ``HostLossError`` on expiry."""
        self.process_index = (multihost.process_index() if process_index is None
                              else int(process_index))
        self.process_count = max(1, multihost.process_count() if process_count is None
                                 else int(process_count))
        self.barrier_timeout = float(barrier_timeout)
        self.poll_interval = float(poll_interval)
        self._barrier = barrier
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # guards _inflight and serializes GC decisions across the async
        # worker and concurrent synchronous saves
        self._lock = threading.Lock()
        self._inflight: set[int] = set()
        #: seconds and bytes of the newest completed save: ``snapshot_s``
        #: (device → host), ``write_s`` (shard and manifest, fsync'd, and
        #: the publish), ``sha256_s`` (the hashing thread's busy time, which
        #: overlaps the write), ``sha256_wait_s`` (what the hash added after
        #: the write) and ``bytes`` (the shard file)
        self.last_save: dict = {}

    # -- save ---------------------------------------------------------------

    def _snapshot(self, tree: Any) -> tuple[list[str], list[_HostLeaf], float]:
        t0 = time.perf_counter()
        pairs = _flatten(tree)
        leaves = [_HostLeaf(leaf) for _, leaf in pairs]
        return [n for n, _ in pairs], leaves, time.perf_counter() - t0

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> str:
        """Synchronous atomic save; returns the checkpoint path.

        ``extra`` is free-form JSON-able run metadata stored in the manifest
        (e.g. the saving run's device count, for elastic-restart planning).
        """
        host = self._snapshot(tree)
        with self._lock:
            self._inflight.add(step)
        try:
            return self._write(step, host, extra)
        finally:
            with self._lock:
                self._inflight.discard(step)

    def save_async(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        """Snapshot to host now, write on a background thread.

        The step is registered in-flight *before* the thread starts, so a
        concurrent save's garbage collection can never delete it mid-write.
        """
        self.wait()  # one in-flight async save at a time
        host = self._snapshot(tree)
        with self._lock:
            self._inflight.add(step)

        def work():
            try:
                self._write(step, host, extra)
            except BaseException as e:  # re-raised on next wait()
                self._error = e
            finally:
                with self._lock:
                    self._inflight.discard(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight async save and RE-RAISE its exception, if any.

        A swallowed write error would let training continue believing a
        checkpoint exists; the failure must surface on the training thread.
        """
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _get_barrier(self) -> Any:
        if self._barrier is None:
            self._barrier = multihost.default_barrier(self.barrier_timeout)
            if self._barrier is None:
                raise RuntimeError(
                    f"process_count={self.process_count} needs a coordination "
                    "barrier: initialize torch.distributed "
                    "(multihost.initialize()) or inject barrier= explicitly"
                )
        return self._barrier

    @staticmethod
    def _write_shard(path: str, names: list[str], leaves: list[_HostLeaf]) -> tuple[str, float, _HashingWriter]:
        """Write and fsync one shard, hashing it as it is written; returns
        (sha256, the write's end time, the writer)."""
        with open(path, "wb") as f:
            w = _HashingWriter(f)
            try:
                _write_npz(w, names, leaves)
                f.flush()
                os.fsync(f.fileno())
                t1 = time.perf_counter()
            finally:
                digest = w.hexdigest()  # also ends the hashing thread on a failed write
        return digest, t1, w

    def _write(self, step: int, host: tuple, extra: dict | None = None) -> str:
        if self.process_count > 1:
            return self._write_multihost(step, host, extra)
        names, leaves, snapshot_s = host
        t0 = time.perf_counter()
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shard_name = "shard_0.npz"
        shard_path = os.path.join(tmp, shard_name)
        digest, t1, w = self._write_shard(shard_path, names, leaves)
        t2 = time.perf_counter()
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": step,
            "time": time.time(),
            "num_shards": 1,
            "leaves": {n: {"shape": list(leaf.array.shape), "dtype": leaf.dtype}
                       for n, leaf in zip(names, leaves)},
            # checksums cover every data file; the manifest itself is the
            # completion marker (written+fsync'd last, then the dir rename)
            "checksums": {shard_name: digest},
            "extra": dict(extra) if extra else {},
        }
        _fsync_write(os.path.join(tmp, "manifest.json"),
                     lambda f: f.write(json.dumps(manifest).encode()))
        self._publish(tmp, final)
        self._gc()
        t3 = time.perf_counter()
        self.last_save = {"step": step, "snapshot_s": snapshot_s,
                          "write_s": (t1 - t0) + (t3 - t2), "sha256_s": w.hash_s,
                          "sha256_wait_s": t2 - t1,
                          "bytes": os.path.getsize(os.path.join(final, shard_name))}
        return final

    def _publish(self, tmp: str, final: str) -> None:
        """Atomically rename the staging dir into place, durably."""
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # fsync the parent directory so the rename itself is durable
        dirfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    # -- multi-host two-phase commit ----------------------------------------

    def _write_multihost(self, step: int, host: tuple, extra: dict | None = None) -> str:
        names, leaves, snapshot_s = host
        t0 = time.perf_counter()
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        bar = self._get_barrier()
        coordinator = self.process_index == 0
        # rendezvous BEFORE touching the staging dir: once every host is
        # here, nobody can still be writing into a previous attempt's tmp
        bar.wait(f"ckpt_{step}_enter")
        if coordinator:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        bar.wait(f"ckpt_{step}_staged")
        # phase 1: every host fsyncs its own shard + checksummed host manifest
        shard_name = f"shard_{self.process_index}.npz"
        shard_path = os.path.join(tmp, shard_name)
        digest, _, w = self._write_shard(shard_path, names, leaves)
        host_manifest = {
            "process_index": self.process_index,
            "checksums": {shard_name: digest},
            "leaves": {n: {"shape": list(leaf.array.shape), "dtype": leaf.dtype}
                       for n, leaf in zip(names, leaves)},
        }
        hm_final = os.path.join(tmp, f"host_{self.process_index}.json")
        _fsync_write(hm_final + ".tmp", lambda f: f.write(json.dumps(host_manifest).encode()))
        os.replace(hm_final + ".tmp", hm_final)
        if not coordinator:
            # phase 2 (follower): wait for the coordinator's publication
            self._await_publication(final, step)
        else:
            # phase 2 (coordinator): collect every host's manifest, re-hash
            # every shard against its host's checksum, publish ONE manifest
            host_manifests = self._collect_host_manifests(tmp)
            checksums: dict[str, str] = {}
            leaves_meta: dict[str, Any] = {}
            for hm in host_manifests:
                for fn, want in hm["checksums"].items():
                    got = _sha256_file(os.path.join(tmp, fn))
                    if got != want:
                        raise CheckpointCorruptionError(
                            f"{tmp}: host {hm['process_index']} shard {fn} checksum mismatch "
                            f"before publish (host manifest {want[:12]}…, file {got[:12]}…)")
                    checksums[fn] = want
                leaves_meta.update(hm["leaves"])
            manifest = {
                "format": MULTIHOST_MANIFEST_FORMAT,
                "step": step,
                "time": time.time(),
                "num_shards": self.process_count,
                "hosts": sorted(hm["process_index"] for hm in host_manifests),
                "leaves": leaves_meta,
                "checksums": checksums,
                "extra": dict(extra) if extra else {},
            }
            _fsync_write(os.path.join(tmp, "manifest.json"),
                         lambda f: f.write(json.dumps(manifest).encode()))
            self._publish(tmp, final)
            self._gc()  # coordinator-only: followers never delete checkpoints
        self.last_save = {"step": step, "snapshot_s": snapshot_s,
                          "write_s": time.perf_counter() - t0, "sha256_s": w.hash_s,
                          "bytes": os.path.getsize(os.path.join(final, shard_name))}
        return final

    def _collect_host_manifests(self, tmp: str) -> list[dict]:
        """Coordinator: poll until every host's manifest exists and parses;
        a host that never delivers within ``barrier_timeout`` is presumed
        dead and nothing is published."""
        deadline = time.monotonic() + self.barrier_timeout
        want = set(range(self.process_count))
        have: dict[int, dict] = {}
        while True:
            for i in sorted(want - set(have)):
                try:
                    with open(os.path.join(tmp, f"host_{i}.json")) as f:
                        have[i] = json.load(f)
                except (FileNotFoundError, json.JSONDecodeError, OSError):
                    continue
            if set(have) == want:
                return [have[i] for i in sorted(have)]
            if time.monotonic() > deadline:
                missing = sorted(want - set(have))
                raise HostLossError(
                    f"distributed checkpoint: host manifest(s) from {missing} never arrived "
                    f"within {self.barrier_timeout}s — publishing nothing", hosts=missing)
            time.sleep(self.poll_interval)

    def _await_publication(self, final: str, step: int) -> None:
        """Follower: block until the coordinator's atomic publish appears."""
        deadline = time.monotonic() + self.barrier_timeout
        while True:
            try:
                with open(os.path.join(final, "manifest.json")) as f:
                    if int(json.load(f).get("step", -1)) == step:
                        return
            except (FileNotFoundError, NotADirectoryError, json.JSONDecodeError, OSError):
                pass
            if time.monotonic() > deadline:
                raise HostLossError(
                    f"distributed checkpoint step {step}: coordinator never published "
                    f"within {self.barrier_timeout}s — presumed dead", hosts=[0])
            time.sleep(self.poll_interval)

    def _gc(self) -> None:
        if not self.keep_last:
            return
        with self._lock:
            inflight = set(self._inflight)
        steps = self.all_steps()
        # the keep window is computed over completed AND in-flight steps so
        # overlapping saves cannot over-delete, and an in-flight step is
        # never a deletion candidate whatever its age
        known = sorted(set(steps) | inflight)
        keep = set(known[-self.keep_last:]) | inflight
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                              ignore_errors=True)

    # -- validation ---------------------------------------------------------

    def manifest(self, step: int) -> dict:
        """Parse and return the manifest of checkpoint ``step`` (raises
        ``CheckpointCorruptionError`` if missing or unparseable)."""
        path = os.path.join(self.directory, f"step_{step}", "manifest.json")
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise CheckpointCorruptionError(f"{path}: manifest missing")
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CheckpointCorruptionError(f"{path}: manifest unreadable ({e})")

    def validate_step(self, step: int) -> dict:
        """Full integrity check of one checkpoint; returns its manifest.

        Raises ``CheckpointCorruptionError`` when the manifest is torn, a
        shard file is missing, or a file's sha256 disagrees with the
        manifest.  Format-1 manifests (no checksums) validate on shard
        presence alone.
        """
        path = os.path.join(self.directory, f"step_{step}")
        manifest = self.manifest(step)
        shards = [f for f in os.listdir(path)
                  if f.startswith("shard_") and f.endswith(".npz")]
        want_shards = int(manifest.get("num_shards", 1))
        if len(shards) < want_shards:
            raise CheckpointCorruptionError(
                f"{path}: {len(shards)} shard file(s) present, manifest "
                f"promises {want_shards}"
            )
        for fn, want in manifest.get("checksums", {}).items():
            fpath = os.path.join(path, fn)
            if not os.path.exists(fpath):
                raise CheckpointCorruptionError(f"{path}: {fn} missing")
            got = _sha256_file(fpath)
            if got != want:
                raise CheckpointCorruptionError(
                    f"{path}: checksum mismatch on {fn} "
                    f"(manifest {want[:12]}…, file {got[:12]}…)"
                )
        return manifest

    def is_valid_step(self, step: int) -> bool:
        try:
            self.validate_step(step)
            return True
        except CheckpointCorruptionError:
            return False

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Steps with a manifest on disk — *candidates*, not guarantees;
        use ``latest_valid_step``/``validate_step`` before trusting one."""
        out = []
        for d in os.listdir(self.directory):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_valid_step(self) -> int | None:
        """Newest step that passes full validation; torn / corrupted /
        partially deleted checkpoints are skipped."""
        for step in reversed(self.all_steps()):
            if self.is_valid_step(step):
                return step
        return None

    def restore(self, step: int, target: Any, *, verify: bool = True) -> Any:
        """Restore into the structure of ``target`` (values ignored); each
        leaf lands on the device of ``target``'s matching leaf, in the dtype
        the checkpoint holds.  With ``verify`` (default) the checksums are
        validated first, so corruption surfaces as
        ``CheckpointCorruptionError`` instead of a garbage state."""
        path = os.path.join(self.directory, f"step_{step}")
        pairs = _flatten(target)
        manifest = self.validate_step(step) if verify else self.manifest(step)
        data: dict[str, np.ndarray] = {}
        for fn in os.listdir(path):
            if fn.startswith("shard_") and fn.endswith(".npz"):
                data.update(_read_npz(os.path.join(path, fn)))
        missing = [n for n, _ in pairs if n not in data]
        if missing:
            raise CheckpointCorruptionError(
                f"{path}: leaves missing from shard files: {missing[:4]}"
                f"{'…' if len(missing) > 4 else ''}"
            )
        flat: list[torch.Tensor] = []
        for n, leaf in pairs:
            want = manifest["leaves"].get(n, {}).get("dtype")
            dev = (leaf[0] if isinstance(leaf, Stacked) else leaf).device
            t = _to_tensor(data.pop(n), want, dev)
            flat.extend(t.unbind(0) if isinstance(leaf, Stacked) else [t])
        return T.unflatten(target, flat)
