"""Fault tolerance & elasticity utilities (a copy of
``repro.distributed.fault_tolerance``: numpy-free, so both packages derive
the same cursors and plans; the straggler monitor times a step on the card
with events).

Pieces (composed by the Trainer):
  * ``StragglerMonitor`` — per-step time EWMA (device time on a card) with
    z-score flagging of slow steps (on real fleets: per-host step times
    gathered through a lightweight all-gather; here: the local signal and
    the policy).
  * ``restart_state`` — deterministic recovery: the trainer's RNG, the MILO
    selector's epoch window, and the data-pipeline cursor are all pure
    functions of (seed, step), so resuming from checkpoint step N replays
    the exact same sample order with zero coordination.
  * ``elastic_plan`` — given old/new device counts, decides the new mesh
    shape and whether global batch is preserved via grad-accumulation
    (device loss => more microbatches, not a silently smaller batch).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from repro_torch import obs


class HostLossError(RuntimeError):
    """A peer host is dead or unreachable (missed heartbeats, an unreached
    coordination barrier, or a host manifest that never arrived during a
    two-phase distributed checkpoint).

    ``hosts`` names the processes believed lost when known.  The recovery
    contract: the launcher restarts with the surviving host count,
    ``elastic_plan`` re-meshes deterministically, and the run resumes from
    the last *globally*-valid checkpoint (``latest_valid_step`` skips any
    step missing a host's shards).
    """

    def __init__(self, message: str, *, hosts: tuple[int, ...] | list[int] = ()):
        super().__init__(message)
        self.hosts = tuple(int(h) for h in hosts)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than mean + z * std.

    On a card (``device`` a CUDA device) a step's time is the device time
    between timing events recorded by ``start`` and ``stop`` on the current
    stream (``obs.device_event``), and a step is observed once its end event
    has completed: late, and without a synchronisation.  ``drain`` waits for
    the steps still pending.  Elsewhere the host clock times the step and
    ``stop`` observes it at once."""

    alpha: float = 0.1
    z_threshold: float = 3.0
    warmup_steps: int = 5
    device: str | torch.device | None = None

    def __post_init__(self):
        self._mean = 0.0
        self._var = 0.0
        self._n = 0
        self._last_start = None
        self._pending: deque = deque()
        self.flagged: list[tuple[int, float]] = []

    def _on_card(self) -> bool:
        return (self.device is not None and torch.device(self.device).type == "cuda"
                and torch.cuda.is_available())

    def start(self) -> None:
        self._last_start = obs.device_event(self.device) if self._on_card() else time.perf_counter()

    def stop(self, step: int) -> bool:
        """Record the step; return True if a step observed now is a
        straggler (on a card, the steps whose end has completed by now)."""
        assert self._last_start is not None, "stop() without start()"
        start, self._last_start = self._last_start, None
        if not self._on_card():
            return self.observe(step, time.perf_counter() - start)
        self._pending.append((step, start, obs.device_event(self.device)))
        return self._poll(wait=False)

    def _poll(self, *, wait: bool) -> bool:
        slow = False
        while self._pending and (wait or self._pending[0][2].query()):
            step, start, end = self._pending.popleft()
            slow = self.observe(step, obs.elapsed_ms(start, end) * 1e-3) or slow
        return slow

    def drain(self) -> None:
        """Observe every pending step, waiting for the card where needed."""
        self._poll(wait=True)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps:
            # Welford running mean/variance over the warmup window.  The old
            # ``(mean + dt) / 2`` halved every previous observation's weight
            # each step — an exponentially-biased average that let one slow
            # early step dominate the baseline the z-score compares against.
            d = dt - self._mean
            self._mean += d / self._n
            self._var += (d * (dt - self._mean) - self._var) / self._n
            return False
        slow = False
        std = self._var ** 0.5
        if std > 0 and (dt - self._mean) / std > self.z_threshold:
            slow = True
            self.flagged.append((step, dt))
        d = dt - self._mean
        self._mean += self.alpha * d
        self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        return slow

    @property
    def mean_step_time(self) -> float:
        return self._mean


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    grad_accum: int           # microbatches per step to preserve global batch
    note: str


def elastic_plan(
    n_devices: int,
    *,
    model_parallel: int,
    global_batch: int,
    microbatch_per_replica: int,
) -> ElasticPlan:
    """Choose (data, model) mesh + grad-accum for the devices we actually have.

    model_parallel is fixed by the architecture's memory footprint; the data
    axis absorbs whatever devices remain.  If the surviving data axis cannot
    cover the global batch in one shot, we keep the *global batch constant*
    by accumulating gradients over more microbatches (semantics-preserving
    elasticity — loss curves stay comparable across restarts).
    """
    if n_devices % model_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel={model_parallel}"
        )
    data = n_devices // model_parallel
    per_step = data * microbatch_per_replica
    if global_batch % per_step:
        # shrink microbatch until it divides
        mb = microbatch_per_replica
        while mb > 1 and global_batch % (data * mb):
            mb -= 1
        per_step = data * mb
        if global_batch % per_step:
            raise ValueError(
                f"global batch {global_batch} cannot be tiled on {data}-way data axis"
            )
    accum = global_batch // per_step
    return ElasticPlan(
        mesh_shape=(data, model_parallel),
        grad_accum=accum,
        note=f"{n_devices} devices -> mesh (data={data}, model={model_parallel}), "
             f"{accum} microbatch(es) to hold global_batch={global_batch}",
    )


def restart_state(seed: int, step: int, steps_per_epoch: int) -> dict:
    """Deterministic cursor for resume: everything derives from (seed, step).

    ``data_seed`` is the epoch's permutation seed exactly as
    ``data.pipeline.Pipeline._permuted`` derives it (``seed * 1_000_003 +
    epoch``) — the two MUST agree, or a restart driven by this cursor would
    replay a different batch order than the run it is resuming.  The old
    independent derivation (``seed + epoch * 1_000_003``) disagreed with the
    pipeline for every ``seed > 0``.
    """
    if steps_per_epoch < 1:
        raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
    epoch = step // steps_per_epoch
    return {
        "epoch": epoch,
        "step_in_epoch": step % steps_per_epoch,
        "data_seed": seed * 1_000_003 + epoch,
    }
