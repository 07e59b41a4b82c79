"""Host input pipeline with first-class subset selection (port of the host
path of ``repro.data.pipeline``).

Each epoch the pipeline asks its selector for a ``SelectionPlan``, shuffles
it with the reference's numpy permutation seeded ``seed * 1_000_003 +
epoch`` (so both packages visit the same batches in the same order), tiles
it into batches and yields host arrays, the plan weights riding along under
``weights``.  Everything is a pure function of (seed, epoch, step).

The device-resident ``device_epoch`` fast path and the background prefetch
thread are not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np


@dataclasses.dataclass
class Pipeline:
    make_batch: Callable[[np.ndarray], dict]   # indices -> host batch
    selector: Any                              # anything with plan(epoch)
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True
    weight_key: str | None = "weights"         # None disables weight injection

    def __post_init__(self):
        self._plan_cache: tuple[int, Any] | None = None

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
