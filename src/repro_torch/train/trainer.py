"""Curriculum trainer: the step loop and the fused device-resident engine
(port of ``repro.train.trainer``).

``fit`` walks the epochs; each epoch takes the pipeline's batches of the
selector's plan, runs ``train_step`` on each and logs every
``log_every_steps`` steps a history record carrying the curriculum phase
(sge/wre/fixed/adaptive); ``eval_fn`` runs every ``eval_every_epochs``
epochs.

``Trainer(fused=True, superstep=S)`` swaps the per-batch loop for the
device-resident engine (``train.engine``): the epoch's permuted plan
(indices, weights) goes to the device once, batches are gathered there from
the pipeline's column store, and ``S`` steps run as one segment (one CUDA
graph replay on the card).  Per-step metrics come back stacked and are read
after the next segment has been issued, into the same history records the
loop writes, so both paths consume the same (seed, epoch, step) stream and
write the same records.  Pipelines without an ``arrays`` column store, or a
trainer with a custom ``put_batch``, take the step loop (the reference's
rule: those batches are assembled on the host).

Checkpoints and restart, the divergence guard, heartbeats and the prefetch
thread are not ported yet (ROADMAP A10, A9b, A11, A6); segments are cut as
``segment_length(..., checkpoint_every=0)`` gives them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.data.pipeline import Pipeline
from repro_torch.device import resolve_device
from repro_torch.train import engine as engine_mod


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
        fused: bool = False,
        superstep: int = 32,
        resident_buffers: dict | None = None,
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.eval_fn = eval_fn
        # the fused path builds batches on the device, so a custom put_batch
        # (a host-side placement hook) forces the loop path
        self._custom_put = put_batch is not None
        self.put_batch = put_batch or self._to_device
        self.fused = fused
        self.superstep = superstep
        # externally owned resident columns (e.g. the ones a tune() sweep
        # shares across its trials), else a private copy of the host columns
        self._buffers: dict | None = resident_buffers
        self._pending_history: tuple | None = None
        self.history: list[dict] = []

    def _to_device(self, batch: dict) -> dict:
        dev = resolve_device(self.pipeline.device)
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def fused_active(self) -> bool:
        """Whether fit() will take the device-resident fused path."""
        return (self.fused and not self._custom_put
                and getattr(self.pipeline, "supports_device_epoch", False))

    def fit(self, state: Any) -> Any:
        t0 = time.time()
        self._pending_history = None  # defensive: a prior fit() that raised
        global_step = 0
        run_epoch = self._fused_epoch if self.fused_active() else self._loop_epoch
        for epoch in range(self.tcfg.epochs):
            phase = self.pipeline.plan_for_epoch(epoch).phase
            state, global_step = run_epoch(state, epoch, global_step, t0, phase)
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

    # -- device-resident fused path (train.engine) --------------------------

    def _engine(self):
        return engine_mod.epoch_engine(self.train_step, weight_key=self.pipeline.weight_key)

    def _resident_buffers(self) -> dict:
        if self._buffers is None:
            dev = resolve_device(self.pipeline.device)
            self._buffers = {k: torch.as_tensor(v, device=dev)
                             for k, v in self.pipeline.arrays.items()}
        return self._buffers

    def _fused_epoch(self, state: Any, epoch: int, global_step: int, t0: float,
                     phase: str) -> tuple[Any, int]:
        """One epoch as a walk over segments; returns (state, step)."""
        idx, w = self.pipeline.device_epoch(epoch)
        buffers = self._resident_buffers()
        engine = self._engine()
        log_every = self.tcfg.log_every_steps
        n_steps = int(idx.shape[0])
        pos = 0
        while pos < n_steps:
            seg = engine_mod.segment_length(self.superstep, global_step, n_steps - pos, 0)
            state, metrics = engine(state, buffers, idx[pos:pos + seg], w[pos:pos + seg])
            # read only segments a log boundary falls in; the previous
            # segment's metrics are read now, after this one was issued, so
            # the copy overlaps this segment's run on the card
            if log_every and (global_step + seg) // log_every * log_every > global_step:
                self._drain_history(t0)
                self._pending_history = (metrics, seg, global_step, epoch, phase)
            global_step += seg
            pos += seg
        # epoch boundary: the trailing segment's records land before the
        # eval record, as on the loop path
        self._drain_history(t0)
        return state, global_step

    def _drain_history(self, t0: float) -> None:
        """Replay the pending segment's stacked metrics into per-step
        history records (the device→host copy happens here)."""
        if self._pending_history is None:
            return
        metrics, seg, global_step, epoch, phase = self._pending_history
        self._pending_history = None
        host = {k: v.tolist() for k, v in metrics.items()}
        wall = round(time.time() - t0, 2)  # segment-grain on this path
        for i in range(seg):
            step_i = global_step + i + 1
            if step_i % self.tcfg.log_every_steps:
                continue
            rec = {k: float(v[i]) for k, v in host.items()}
            rec.update(step=step_i, epoch=epoch, phase=phase, wall=wall)
            self.history.append(rec)

    def warm_fused(self, throwaway: Any) -> None:
        """Capture the fused segment graphs outside any timed region.

        Runs epoch 0's segment walk on ``throwaway`` — updated in place, so
        the caller must not reuse it — covering the (full, remainder)
        segment shapes a run cycles through.  No history is written.
        """
        if not self.fused_active():
            return
        idx, w = self.pipeline.device_epoch(0)
        buffers = self._resident_buffers()
        engine = self._engine()
        n_steps = int(idx.shape[0])
        pos = 0
        while pos < n_steps:
            seg = engine_mod.segment_length(self.superstep, pos, n_steps - pos, 0)
            throwaway, _ = engine(throwaway, buffers, idx[pos:pos + seg], w[pos:pos + seg])
            pos += seg
        if idx.device.type == "cuda":
            torch.cuda.synchronize(idx.device)

    def _maybe_eval(self, state: Any, epoch: int, global_step: int, t0: float) -> None:
        if self.eval_fn and self.tcfg.eval_every_epochs and (
            (epoch + 1) % self.tcfg.eval_every_epochs == 0
        ):
            ev = {k: float(v) for k, v in self.eval_fn(state).items()}
            ev.update(step=global_step, epoch=epoch, eval=True,
                      wall=round(time.time() - t0, 2))
            self.history.append(ev)
