"""Host input pipeline with first-class subset selection (port of
``repro.data.pipeline``).

Each epoch the pipeline asks its selector for a ``SelectionPlan`` (a
selector that speaks only the legacy ``indices_for_epoch`` protocol is
wrapped at first use by ``selection.base.ensure_selector``: uniform
weights, the phase inferred from the object), shuffles
it with the reference's numpy permutation seeded ``seed * 1_000_003 +
epoch`` (so both packages visit the same batches in the same order), tiles
it into batches and yields host arrays, the plan weights riding along under
``weights``.  Everything is a pure function of (seed, epoch, step).

Device-resident fast path: when the dataset is a plain column store
(``arrays={"x": feats, "y": labs}``), ``device_epoch`` hands the consumer
the epoch's whole permuted (indices, weights) stream as two tensors on
``device``, one copy an epoch, and the fused engine (``train.engine``)
gathers each batch on the device.  The index stream is the same function
of (seed, epoch, step) as ``epoch()``'s, so the loop and fused paths
consume identical batches.  ``resident`` names externally owned device
copies of the same columns (``serve.BufferRegistry``'s), which the
``Trainer`` then gathers from instead of placing its own.

Background prefetch (``prefetch=True``, the default): a one-slot daemon
thread assembles the next host batches (a queue of 2) while the consumer
runs the current step; a worker exception crosses the queue and is re-raised
in the consumer instead of silently truncating the epoch, and abandoning an
epoch early (break / ``close()`` on the iterator) tells the worker to stop,
so it exits within its put timeout instead of staying blocked on a full
queue with batch arrays pinned.  ``device_epoch`` assembles no host batch
and never starts the thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator, Protocol

import numpy as np
import torch

from repro_torch.device import resolve_device


class Selector(Protocol):
    """Deprecated structural protocol — prefer ``repro_torch.selection.Selector``."""

    def indices_for_epoch(self, epoch: int) -> np.ndarray: ...


@dataclasses.dataclass
class FullSelector:
    """No selection: the whole dataset every epoch (legacy protocol; new code
    should use ``build_selector("full", n=...)``)."""

    n: int

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        return np.arange(self.n, dtype=np.int64)


class _WorkerError:
    """Wrapper carrying a prefetch-worker exception across the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class Pipeline:
    make_batch: Callable[[np.ndarray], dict] | None  # indices -> host batch
    selector: Any              # plan(epoch), or legacy indices_for_epoch(epoch)
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True
    prefetch: bool = True
    weight_key: str | None = "weights"         # None disables weight injection
    # Column store enabling the device-resident path: same-length arrays the
    # batches are gathered from (``batch[k] = arrays[k][idx]``).  Providing
    # it asserts ``make_batch`` is exactly that gather (``make_batch=None``
    # derives it); custom batch assembly must leave this unset — consumers
    # then take the host step loop.
    arrays: dict[str, np.ndarray] | None = None
    # externally owned device tensors of the SAME columns (e.g. a
    # ``serve.BufferRegistry``'s): the Trainer's fused path gathers from
    # them instead of placing its own copy, so concurrent trainers over one
    # dataset share one buffer per column; same keys and shapes as ``arrays``
    resident: dict[str, torch.Tensor] | None = None
    # where batches and the device-resident stream go (the card unless the
    # caller asks for the CPU); resolved at first use
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self._plan_cache: tuple[int, Any] | None = None
        self._plan_selector: Any = None
        if self.arrays is not None:
            lengths = {k: len(v) for k, v in self.arrays.items()}
            if len(set(lengths.values())) > 1:
                raise ValueError(f"arrays columns disagree on length: {lengths}")
            if self.weight_key and self.weight_key in self.arrays:
                raise ValueError(
                    f"arrays column {self.weight_key!r} collides with "
                    "weight_key: plan weights would silently shadow it")
        if self.resident is not None:
            if self.arrays is None:
                raise ValueError("resident buffers require the arrays column store they mirror")
            if set(self.resident) != set(self.arrays):
                raise ValueError(
                    f"resident buffers cover {sorted(self.resident)} but the column store "
                    f"holds {sorted(self.arrays)}; they must mirror the same columns")
            for k, buf in self.resident.items():
                if tuple(buf.shape) != tuple(np.shape(self.arrays[k])):
                    raise ValueError(
                        f"resident buffer {k!r} has shape {tuple(buf.shape)} but the host "
                        f"column is {tuple(np.shape(self.arrays[k]))}")
        if self.make_batch is None:
            if self.arrays is None:
                raise ValueError("make_batch=None requires arrays")
            cols = self.arrays

            def gather(idx: np.ndarray) -> dict:
                return {k: v[idx] for k, v in cols.items()}

            self.make_batch = gather

    @property
    def supports_device_epoch(self) -> bool:
        """True when the device-resident fast path is available."""
        return self.arrays is not None

    def invalidate_plan_cache(self) -> None:
        """Drop the memoized epoch plan (e.g. after a selector cache reset)."""
        self._plan_cache = None

    def plan_for_epoch(self, epoch: int):
        """The selector's (cached) SelectionPlan for this epoch."""
        if self._plan_cache is not None and self._plan_cache[0] == epoch:
            return self._plan_cache[1]
        if self._plan_selector is None:
            # deferred: data sits below selection in the layering
            from repro_torch.selection.base import ensure_selector

            self._plan_selector = ensure_selector(self.selector)
        plan = self._plan_selector.plan(epoch)
        self._plan_cache = (epoch, plan)
        return plan

    def _permuted(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """(indices, weights) in this epoch's deterministic visit order."""
        plan = self.plan_for_epoch(epoch)
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        perm = rng.permutation(len(plan.indices))
        return plan.indices[perm], plan.weights[perm]

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The epoch's indices in their visit order."""
        return self._permuted(epoch)[0]

    def steps_per_epoch(self, epoch: int = 0) -> int:
        n = len(self.plan_for_epoch(epoch).indices)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def device_epoch(self, epoch: int, *, start_step: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """The epoch's remaining (indices, weights) as ``(n_steps, batch)``
        int64 and float32 tensors on ``device``, in one copy each.

        Step ``s`` of the result is exactly the (index, weight) content of
        the ``s + start_step``-th batch ``epoch()`` would yield — same
        permutation, same drop/wrap-pad remainder handling.
        """
        if self.arrays is None:
            raise ValueError(
                "device_epoch needs the arrays column store; this pipeline "
                "assembles custom host batches — use epoch()")
        idx, weights = self._permuted(epoch)
        n_steps = self.steps_per_epoch(epoch)
        take = n_steps * self.batch_size
        if take > len(idx):
            # not drop_remainder: wrap-pad the final short batch from its own
            # elements, exactly as epoch() does
            lo = (n_steps - 1) * self.batch_size
            pad = (0, take - len(idx))
            idx = np.concatenate([idx[:lo], np.pad(idx[lo:], pad, mode="wrap")])
            weights = np.concatenate([weights[:lo], np.pad(weights[lo:], pad, mode="wrap")])
        idx = idx[:take].reshape(n_steps, self.batch_size)[start_step:]
        weights = weights[:take].reshape(n_steps, self.batch_size)[start_step:]
        dev = resolve_device(self.device)
        return (torch.as_tensor(np.ascontiguousarray(idx, np.int64), device=dev),
                torch.as_tensor(np.ascontiguousarray(weights, np.float32), device=dev))

    def epoch(self, epoch: int, *, start_step: int = 0) -> Iterator[dict]:
        """Yield batches; ``start_step`` skips ahead for restart replay."""
        idx, weights = self._permuted(epoch)
        n_steps = self.steps_per_epoch(epoch)

        def gen():
            for s in range(start_step, n_steps):
                lo = s * self.batch_size
                sel = idx[lo : lo + self.batch_size]
                w = weights[lo : lo + self.batch_size]
                if len(sel) < self.batch_size:
                    if self.drop_remainder:
                        return
                    pad = self.batch_size - len(sel)
                    sel = np.pad(sel, (0, pad), mode="wrap")
                    w = np.pad(w, (0, pad), mode="wrap")
                b = self.make_batch(sel)
                if self.weight_key and self.weight_key not in b:
                    b[self.weight_key] = w.copy()
                yield b

        if not self.prefetch:
            yield from gen()
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Enqueue unless the consumer has gone away; the timeout bounds
            how long an abandoned worker can stay blocked on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in gen():
                    if not put(b):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                put(_WorkerError(e))
            else:
                put(done)

        t = threading.Thread(target=worker, daemon=True, name="pipeline-prefetch")
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    break
                if isinstance(b, _WorkerError):
                    raise b.exc
                yield b
        finally:
            # on exhaustion and when the consumer stops early (generator
            # close): release the worker and reap it, so no thread is left
            # pinning batch arrays behind a full queue
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
