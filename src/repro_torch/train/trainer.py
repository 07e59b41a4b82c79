"""Curriculum trainer: the plain step loop (port of the loop path of
``repro.train.trainer``).

``fit`` walks the epochs; each epoch takes the pipeline's batches of the
selector's plan, runs ``train_step`` on each and logs every
``log_every_steps`` steps a history record carrying the curriculum phase
(sge/wre/fixed/adaptive); ``eval_fn`` runs every ``eval_every_epochs``
epochs.  Checkpoints and restart, the divergence guard, heartbeats and the
fused device-resident engine are not ported yet (ROADMAP A6, A9, A10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.data.pipeline import Pipeline


@dataclasses.dataclass
class TrainerConfig:
    epochs: int
    eval_every_epochs: int = 0
    log_every_steps: int = 50


class Trainer:
    def __init__(
        self,
        train_step: Callable[[Any, dict], tuple[Any, dict]],
        pipeline: Pipeline,
        tcfg: TrainerConfig,
        *,
        eval_fn: Callable[[Any], dict] | None = None,
        put_batch: Callable[[dict], dict] | None = None,
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.eval_fn = eval_fn
        self.put_batch = put_batch or (lambda b: b)
        self.history: list[dict] = []

    def fit(self, state: Any) -> Any:
        t0 = time.time()
        global_step = 0
        for epoch in range(self.tcfg.epochs):
            phase = self.pipeline.plan_for_epoch(epoch).phase
            state, global_step = self._loop_epoch(state, epoch, global_step, t0, phase)
            self._maybe_eval(state, epoch, global_step, t0)
        return state

    def _loop_epoch(self, state: Any, epoch: int, global_step: int, t0: float,
                    phase: str) -> tuple[Any, int]:
        """One epoch on the per-batch step loop; returns (state, step)."""
        log_every = self.tcfg.log_every_steps
        for batch in self.pipeline.epoch(epoch):
            state, metrics = self.train_step(state, self.put_batch(batch))
            global_step += 1
            if log_every and global_step % log_every == 0:
                # reading the metrics is the one host sync of a logged step
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=global_step, epoch=epoch, phase=phase,
                           wall=round(time.time() - t0, 2))
                self.history.append(rec)
        return state, global_step

    def _maybe_eval(self, state: Any, epoch: int, global_step: int, t0: float) -> None:
        if self.eval_fn and self.tcfg.eval_every_epochs and (
            (epoch + 1) % self.tcfg.eval_every_epochs == 0
        ):
            ev = {k: float(v) for k, v in self.eval_fn(state).items()}
            ev.update(step=global_step, epoch=epoch, eval=True,
                      wall=round(time.time() - t0, 2))
            self.history.append(ev)
