"""Curriculum trainer: MILO subsets, checkpoints and restart, the divergence
guard (port of ``repro.train.trainer``).

The trainer composes:
  * a ``Pipeline`` whose selector is any registry entry (MILO or a
    baseline); the plan's per-sample weights arrive in each batch under
    ``weights`` and are consumed by the loss,
  * a train step (``train_state.make_train_step``, or the session's
    classifier step),
  * ``CheckpointManager`` (atomic, async, checksummed, keep-last-k),
  * ``StragglerMonitor`` (slow steps flagged on the monitor and rolled up by
    ``straggler_report()``),
  * deterministic (seed, epoch, step) replay on restart: ``fit(resume=True)``
    restores the newest checkpoint that passes validation (torn / corrupted
    ones are skipped), derives the mid-epoch cursor through
    ``distributed.fault_tolerance.restart_state`` and — when the device
    count changed since the checkpoint was written — surfaces an
    ``elastic_plan`` on ``Trainer.elastic`` and in the history,
  * the divergence guard (``TrainerConfig.guard``): fused into the step,
    with ``skip_step`` / ``rollback`` / ``abort`` on the host.

History records carry the curriculum ``phase`` of the epoch's plan.  They
hold no wall-clock observable but ``wall``: the straggler flags stay on the
monitor, so a record is a pure function of the run's data and the step loop
and the fused path write the same records.

``Trainer(fused=True, superstep=S)`` swaps the per-batch loop for the
device-resident engine (``train.engine``): the epoch's permuted plan
(indices, weights) goes to the device once, batches are gathered there from
the pipeline's column store, and ``S`` steps run as one segment (one CUDA
graph replay on the card).  Segments end on ``checkpoint_every_steps``
multiples, so a checkpoint holds the state at that step; per-step metrics
come back stacked and are read after the next segment has been issued.
Pipelines without an ``arrays`` column store, or a trainer with a custom
``put_batch``, take the step loop (those batches are assembled on the host,
behind the pipeline's prefetch thread).

Multi-host runs: every host runs the whole replicated step (no gradient
all-reduce, as in the reference); checkpoints take the two-phase
coordinated commit when ``torch.distributed`` has more than one process
(``barrier_timeout`` bounds each of its waits), and with ``heartbeat_dir``
every host writes its beacon at every step or segment boundary and checks
its peers' — a stale peer raises ``HostLossError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.data.pipeline import Pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import multihost
from repro_torch.distributed.fault_tolerance import (
    ElasticPlan,
    StragglerMonitor,
    elastic_plan,
    restart_state,
)
from repro_torch.health import guard as guard_mod
from repro_torch.health.guard import DivergenceError, GuardPolicy
from repro_torch.train import engine as engine_mod


class _GuardRollback(Exception):
    """Internal control flow: a stretch tripped the rollback guard.

    Carries the step the bad stretch ended on and the (post-skip) state to
    use as the restore template.
    """

    def __init__(self, step: int, state: Any):
        super().__init__(f"guard rollback at step {step}")
        self.step = step
        self.state = state


@dataclasses.dataclass
class TrainerConfig:
    epochs: int
    eval_every_epochs: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 0
    async_checkpoint: bool = True
    log_every_steps: int = 50
    # model-parallel degree assumed by the elastic-restart planner: when a
    # resumed run sees a different device count than the run that wrote the
    # checkpoint, ``elastic_plan`` re-tiles (data, model) and computes the
    # grad-accumulation factor that keeps the global batch constant
    model_parallel: int = 1
    # fused path only: read segment i's stacked metrics after segment i+1
    # has been issued (False reads them in line); records are the same
    async_history: bool = True
    # divergence guard (repro_torch.health.GuardPolicy) or None: fused into
    # the step (inside the graph on the fused path); "skip_step" adds no
    # host read, "rollback"/"abort" read one flag vector per segment (per
    # step on the loop path).  "rollback" restores latest_valid_step and
    # replays; flags at or before the rolled-back step are tolerated on
    # replay, so a deterministic fault cannot re-trigger forever
    guard: GuardPolicy | None = None
    # multi-host liveness: when set, this host writes a heartbeat beacon
    # (``multihost.HeartbeatWriter``) at every step/segment boundary and
    # checks every peer's freshness — a peer stale past
    # ``heartbeat_timeout`` raises ``HostLossError``.  The directory must be
    # shared by the job's hosts
    heartbeat_dir: str | None = None
    heartbeat_timeout: float = 60.0
    # bound on every wait a dead peer could hang inside the two-phase
    # distributed checkpoint (barriers, manifest collection, publication
    # poll); expiry raises HostLossError instead of deadlocking the job
    barrier_timeout: float = 120.0


def _to_host(metrics: dict) -> dict:
    """The metrics as Python floats (lists for stacked ones) in ONE
    device-to-host copy, whatever their number: the guard's flag adds no
    host read."""
    if not metrics:
        return {}
    vals = torch.stack([torch.as_tensor(v).to(torch.float64) for v in metrics.values()])
    return dict(zip(metrics, vals.tolist()))


def _device_count(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _process_count() -> int:
    return multihost.process_count()


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
        # shares across its trials; highest precedence), then the
        # pipeline's shared ``resident`` columns, else a private copy of the
        # host columns
        self._buffers: dict | None = resident_buffers
        self._pending_history: tuple | None = None
        self.monitor = StragglerMonitor()
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, barrier_timeout=tcfg.barrier_timeout)
                     if tcfg.checkpoint_dir else None)
        # multi-host liveness: beat + check at every step/segment boundary
        if tcfg.heartbeat_dir:
            self.heartbeat = multihost.HeartbeatWriter(tcfg.heartbeat_dir)
            self.liveness = multihost.HeartbeatMonitor(
                tcfg.heartbeat_dir, timeout=tcfg.heartbeat_timeout,
                expected=multihost.process_count())
        else:
            self.heartbeat = None
            self.liveness = None
        self.history: list[dict] = []
        # elastic-restart plan computed when a resume sees a different
        # device count than the checkpoint's writer (None otherwise)
        self.elastic: ElasticPlan | None = None
        self.guard = tcfg.guard
        self.guard_events: list[dict] = []
        self._guard_skips = 0
        self._guard_rollbacks = 0
        # steps at/before this mark had their rollback consumed: on replay
        # the deterministic fault re-fires and is tolerated as a skip
        self._tolerate_through = -1
        # loop-path step with the guard fused in (the fused path gets it
        # inside the engine's segment instead)
        self._step = (guard_mod.guarded_step(self.train_step, self.guard)
                      if self.guard is not None else self.train_step)

    def _device(self) -> torch.device:
        return resolve_device(self.pipeline.device)

    def _to_device(self, batch: dict) -> dict:
        dev = self._device()
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def fused_active(self) -> bool:
        """Whether fit() will take the device-resident fused path."""
        return (self.fused and not self._custom_put
                and getattr(self.pipeline, "supports_device_epoch", False))

    def _epoch_phase(self, epoch: int) -> str | None:
        plan_fn = getattr(self.pipeline, "plan_for_epoch", None)
        return None if plan_fn is None else plan_fn(epoch).phase

    def _ckpt_extra(self) -> dict:
        """Run metadata stamped into every checkpoint manifest: what an
        elastic restart needs to compare against the resuming environment."""
        return {
            "device_count": _device_count(self._device()),
            "process_count": _process_count(),
            "data_seed": self.pipeline.seed,
            "batch_size": self.pipeline.batch_size,
        }

    def _beat_and_check(self, global_step: int) -> None:
        """Heartbeat + dead-host detection at a step/segment boundary: raises
        ``HostLossError`` when any peer's beacon is stale."""
        if self.heartbeat is None:
            return
        self.heartbeat.beat(global_step)
        self.liveness.check()

    def _save_checkpoint(self, global_step: int, state: Any) -> None:
        if self.tcfg.async_checkpoint:
            self.ckpt.save_async(global_step, state, extra=self._ckpt_extra())
        else:
            self.ckpt.save(global_step, state, extra=self._ckpt_extra())

    def _maybe_restore(self, state: Any, t0: float) -> tuple[Any, int]:
        """Resume from the newest checkpoint that passes validation (torn or
        corrupted ones are skipped); surface an ``elastic_plan`` when the
        device count changed since it was written."""
        if self.ckpt is None:
            return state, 0
        latest = self.ckpt.latest_valid_step()
        if latest is None:
            return state, 0
        state = self.ckpt.restore(latest, state)
        extra = self.ckpt.manifest(latest).get("extra", {})
        saved_devices = extra.get("device_count")
        now_devices = _device_count(self._device())
        saved_procs = extra.get("process_count")
        now_procs = _process_count()
        if saved_procs and saved_procs != now_procs and (
                not saved_devices or saved_devices == now_devices):
            # host count changed but the device count happens to match:
            # still surface the topology change
            self.history.append({
                "elastic": True, "step": latest,
                "process_count": [saved_procs, now_procs],
                "grad_accum": None, "mesh_shape": None,
                "note": f"process count {saved_procs} -> {now_procs} with unchanged "
                        "device count",
                "wall": round(time.time() - t0, 2),
            })
        if saved_devices and saved_devices != now_devices:
            batch = extra.get("batch_size", self.pipeline.batch_size)
            try:
                self.elastic = elastic_plan(
                    now_devices,
                    model_parallel=self.tcfg.model_parallel,
                    global_batch=batch,
                    microbatch_per_replica=max(1, batch // saved_devices),
                )
                rec = {"elastic": True, "step": latest,
                       "grad_accum": self.elastic.grad_accum,
                       "mesh_shape": list(self.elastic.mesh_shape),
                       "note": self.elastic.note}
                if saved_procs:
                    rec["process_count"] = [saved_procs, now_procs]
            except ValueError as e:
                # a device count the batch cannot tile: surface it, the
                # state itself restored fine
                rec = {"elastic": True, "step": latest, "grad_accum": None,
                       "mesh_shape": None, "note": f"no elastic plan: {e}"}
            rec["wall"] = round(time.time() - t0, 2)
            self.history.append(rec)
        return state, latest

    # -- device-resident fused path (train.engine) --------------------------

    def _engine(self):
        return engine_mod.epoch_engine(self.train_step, weight_key=self.pipeline.weight_key,
                                       guard=self.guard)

    def _resident_buffers(self) -> dict:
        if self._buffers is None:
            shared = getattr(self.pipeline, "resident", None)
            self._buffers = shared if shared is not None else {
                k: torch.as_tensor(v, device=self._device())
                for k, v in self.pipeline.arrays.items()}
        return self._buffers

    def _fused_epoch(self, box: list, epoch: int, start_step: int, global_step: int,
                     t0: float, phase: str | None) -> tuple[Any, int]:
        """One epoch as a walk over segments, on the state taken out of
        ``box``; returns (state, step)."""
        state = box.pop()
        idx, w = self.pipeline.device_epoch(epoch, start_step=start_step)
        buffers = self._resident_buffers()
        engine = self._engine()
        ckpt_every = self.tcfg.checkpoint_every_steps if self.ckpt else 0
        log_every = self.tcfg.log_every_steps
        n_steps = int(idx.shape[0])
        pos = 0
        while pos < n_steps:
            seg = engine_mod.segment_length(self.superstep, global_step, n_steps - pos,
                                            ckpt_every)
            self.monitor.start()
            state, metrics = engine(state, buffers, idx[pos:pos + seg], w[pos:pos + seg])
            self.monitor.stop(global_step + seg)
            self._beat_and_check(global_step + seg)
            # rollback/abort must decide before this segment's state can be
            # checkpointed; skip_step stays read-free (the flag rides the drain)
            if self.guard is not None and self.guard.action != "skip_step":
                bad = int(torch.count_nonzero(metrics[guard_mod.GUARD_KEY] > 0))
                if bad:
                    self._on_guard_bad(bad, global_step + seg, epoch, state)
            # read only segments a log boundary falls in; with async_history
            # the previous segment's metrics are read now, after this one
            # was issued, so the copy overlaps this segment's run on the card
            if log_every and (global_step + seg) // log_every * log_every > global_step:
                pending = (metrics, seg, global_step, epoch, phase)
                if self.tcfg.async_history:
                    self._drain_history(t0)
                    self._pending_history = pending
                else:
                    self._pending_history = pending
                    self._drain_history(t0)
            global_step += seg
            pos += seg
            if ckpt_every and global_step % ckpt_every == 0:
                self._save_checkpoint(global_step, state)
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
        host = _to_host(metrics)
        wall = round(time.time() - t0, 2)  # segment-grain on this path
        if self.guard is not None and guard_mod.GUARD_KEY in host:
            # skip events are observed here, off the copy the drain already
            # pays; for rollback policies the segments that reach the drain
            # were clean or tolerated, so flagged steps here are skips too
            for i, flag in enumerate(host[guard_mod.GUARD_KEY]):
                if flag > 0:
                    self._guard_skips += 1
                    self.guard_events.append({"action": "skip_step",
                                              "step": global_step + i + 1, "epoch": epoch})
        for i in range(seg):
            step_i = global_step + i + 1
            if step_i % self.tcfg.log_every_steps:
                continue
            rec = {k: float(v[i]) for k, v in host.items()}
            rec.update(step=step_i, epoch=epoch, wall=wall)
            if phase is not None:
                rec["phase"] = phase
            self.history.append(rec)

    # -- divergence guard (repro_torch.health.guard) ------------------------

    def _on_guard_bad(self, bad: int, end_step: int, epoch: int, state: Any) -> None:
        """Host-side reaction to flagged steps in the stretch ending at
        ``end_step`` (the device already applied skip semantics)."""
        policy = self.guard
        if end_step <= self._tolerate_through:
            # replaying a rolled-back stretch: the deterministic fault
            # re-fired, as expected — keep the skip and move on
            return
        if policy.action == "abort":
            raise DivergenceError(
                f"training diverged: {bad} non-finite/spiking step(s) in the stretch ending "
                f"at step {end_step} (epoch {epoch}) and GuardPolicy.action='abort'")
        self._guard_rollbacks += 1
        if self._guard_rollbacks > policy.max_rollbacks:
            raise DivergenceError(
                f"training diverged at step {end_step} after exhausting "
                f"max_rollbacks={policy.max_rollbacks} checkpoint restores")
        self.guard_events.append({"action": "rollback", "step": int(end_step),
                                  "epoch": int(epoch), "bad_steps": int(bad)})
        raise _GuardRollback(end_step, state)

    def _guard_restore(self, rb: _GuardRollback, t0: float) -> tuple[Any, int]:
        """Restore the newest valid checkpoint and rewind history to it."""
        if self.ckpt is None:
            raise DivergenceError(
                f"guard action 'rollback' tripped at step {rb.step} but no checkpoint_dir is "
                "configured — set TrainerConfig.checkpoint_dir/checkpoint_every_steps or use "
                "'skip_step'")
        # the still-pending previous segment may precede the restore point:
        # drain it (the truncation below keeps only records <= latest)
        self._drain_history(t0)
        self.ckpt.wait()               # in-flight async saves must land
        latest = self.ckpt.latest_valid_step()
        if latest is None:
            raise DivergenceError(
                f"guard: divergence at step {rb.step} with no valid checkpoint to roll back to")
        state = self.ckpt.restore(latest, rb.state)
        self._tolerate_through = rb.step
        # data/eval records past the restore point get re-written by the
        # replay; the guard marker records stay
        self.history = [h for h in self.history
                        if h.get("step", 0) <= latest or h.get("guard")]
        self.history.append({"guard": "rollback", "step": int(rb.step),
                             "restored_step": int(latest),
                             "wall": round(time.time() - t0, 2)})
        return state, latest

    def guard_report(self) -> dict | None:
        """Run-level divergence-guard roll-up (None when nothing tripped)."""
        if not (self.guard_events or self._guard_skips or self._guard_rollbacks):
            return None
        return {
            "action": self.guard.action if self.guard else None,
            "skipped_steps": int(self._guard_skips),
            "rollbacks": int(self._guard_rollbacks),
            "events": [dict(e) for e in self.guard_events],
        }

    def warm_fused(self, throwaway: Any) -> None:
        """Capture the fused segment graphs outside any timed region.

        Runs epoch 0's segment walk on ``throwaway`` — updated in place, so
        the caller must not reuse it — covering the (full, remainder)
        segment shapes a checkpoint-free run cycles through.  No history,
        checkpoints or monitor records are written.
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

    def fit(self, state: Any, *, resume: bool = True) -> Any:
        t0 = time.time()
        self._pending_history = None  # defensive: a prior fit() that raised
        global_step = 0
        if resume:
            state, global_step = self._maybe_restore(state, t0)
        steps_per_epoch = self.pipeline.steps_per_epoch()
        # the deterministic restart cursor: (epoch, step_in_epoch) are pure
        # functions of (seed, step), so resuming replays the exact batch
        # stream of the uninterrupted run, on either engine path
        cursor = restart_state(self.pipeline.seed, global_step, max(steps_per_epoch, 1))
        start_epoch, start_step = cursor["epoch"], cursor["step_in_epoch"]
        run_epoch = self._fused_epoch if self.fused_active() else self._loop_epoch
        epoch = start_epoch
        # the state travels in a one-slot list the epoch takes it out of, so
        # this frame holds no reference to the epoch's starting state while
        # the epoch builds new ones (on the loop path that would keep a
        # whole extra copy of the parameters and moments alive)
        box = [state]
        del state
        while epoch < self.tcfg.epochs:
            phase = self._epoch_phase(epoch)
            try:
                state, global_step = run_epoch(
                    box, epoch, start_step if epoch == start_epoch else 0,
                    global_step, t0, phase)
                box.append(state)
                del state
            except _GuardRollback as rb:
                state, global_step = self._guard_restore(rb, t0)
                box.append(state)
                del state, rb
                # the cursor at the restored step: the replayed stretch sees
                # the identical batch stream
                cursor = restart_state(self.pipeline.seed, global_step,
                                       max(steps_per_epoch, 1))
                start_epoch, start_step = cursor["epoch"], cursor["step_in_epoch"]
                epoch = start_epoch
                continue
            self._maybe_eval(box[0], epoch, global_step, t0)
            epoch += 1
        state = box.pop()
        if self.ckpt is not None:
            self.ckpt.wait()
            self.ckpt.save(global_step, state, extra=self._ckpt_extra())
        return state

    def _loop_epoch(self, box: list, epoch: int, start_step: int, global_step: int,
                    t0: float, phase: str | None) -> tuple[Any, int]:
        """One epoch on the per-batch step loop, on the state taken out of
        ``box``; returns (state, step)."""
        state = box.pop()
        guard_sync = self.guard is not None and self.guard.action != "skip_step"
        log_every = self.tcfg.log_every_steps
        for batch in self.pipeline.epoch(epoch, start_step=start_step):
            self.monitor.start()
            state, metrics = self._step(state, self.put_batch(batch))
            self.monitor.stop(global_step)
            self._beat_and_check(global_step)
            global_step += 1
            if guard_sync and float(metrics[guard_mod.GUARD_KEY]) > 0:
                self._on_guard_bad(1, global_step, epoch, state)
            if log_every and global_step % log_every == 0:
                # reading the metrics is the one host sync of a logged step
                rec = _to_host(metrics)
                rec.update(step=global_step, epoch=epoch, wall=round(time.time() - t0, 2))
                if phase is not None:
                    rec["phase"] = phase
                self.history.append(rec)
                if rec.get(guard_mod.GUARD_KEY, 0.0) > 0:
                    self._guard_skips += 1
                    self.guard_events.append({"action": "skip_step", "step": global_step,
                                              "epoch": epoch})
            if (self.ckpt is not None and self.tcfg.checkpoint_every_steps
                    and global_step % self.tcfg.checkpoint_every_steps == 0):
                self._save_checkpoint(global_step, state)
        return state, global_step

    def straggler_report(self) -> dict | None:
        """Run-level straggler roll-up (None when nothing was flagged)."""
        if not self.monitor.flagged:
            return None
        return {
            "flagged": [[int(s), float(dt)] for s, dt in self.monitor.flagged],
            "mean_step_time": float(self.monitor.mean_step_time),
        }

    def _maybe_eval(self, state: Any, epoch: int, global_step: int, t0: float) -> None:
        if self.eval_fn and self.tcfg.eval_every_epochs and (
            (epoch + 1) % self.tcfg.eval_every_epochs == 0
        ):
            ev = {k: float(v) for k, v in self.eval_fn(state).items()}
            ev.update(step=global_step, epoch=epoch, eval=True,
                      wall=round(time.time() - t0, 2))
            self.history.append(ev)
