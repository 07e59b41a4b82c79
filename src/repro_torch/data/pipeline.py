"""Host input pipeline with first-class subset selection (port of
``repro.data.pipeline``).

Each epoch the pipeline asks its selector for a ``SelectionPlan``, shuffles
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
consume identical batches.

The reference's background prefetch thread is not ported (ROADMAP A6): the
session's host batches are cheap slices, and its fused path assembles none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Pipeline:
    make_batch: Callable[[np.ndarray], dict] | None  # indices -> host batch
    selector: Any                              # anything with plan(epoch)
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True
    weight_key: str | None = "weights"         # None disables weight injection
    # Column store enabling the device-resident path: same-length arrays the
    # batches are gathered from (``batch[k] = arrays[k][idx]``).  Providing
    # it asserts ``make_batch`` is exactly that gather (``make_batch=None``
    # derives it); custom batch assembly must leave this unset — consumers
    # then take the host step loop.
    arrays: dict[str, np.ndarray] | None = None
    # where batches and the device-resident stream go (the card unless the
    # caller asks for the CPU); resolved at first use
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self._plan_cache: tuple[int, Any] | None = None
        if self.arrays is not None:
            lengths = {k: len(v) for k, v in self.arrays.items()}
            if len(set(lengths.values())) > 1:
                raise ValueError(f"arrays columns disagree on length: {lengths}")
            if self.weight_key and self.weight_key in self.arrays:
                raise ValueError(
                    f"arrays column {self.weight_key!r} collides with "
                    "weight_key: plan weights would silently shadow it")
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
        plan = self.selector.plan(epoch)
        self._plan_cache = (epoch, plan)
        return plan

    def _permuted(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """(indices, weights) in this epoch's deterministic visit order."""
        plan = self.plan_for_epoch(epoch)
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        perm = rng.permutation(len(plan.indices))
        return plan.indices[perm], plan.weights[perm]

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
        for s in range(start_step, self.steps_per_epoch(epoch)):
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
