"""Deterministic fault-injection harness (port of the single-process part
of ``repro.testing.faults``).

Fault-tolerance claims are only as strong as the faults they were tested
against, and randomised fault injection makes failures unreproducible.
Everything here is **counter-driven**: a fault fires on an exact call number
or training step, so a failing run replays bit-identically under the same
schedule.

Injectable faults (each maps to one failure mode the execution layer must
survive):

  * ``KillAtStep``      — SIGKILL the process at training step N (a drop-in
    ``StragglerMonitor``: assign it to ``trainer.monitor`` and the kill
    lands at the first step/segment boundary >= N).  The process dies
    without unwinding — exactly what preemption looks like to the
    checkpoint layer.
  * ``flaky`` / ``fail_nth_calls`` — scripted exceptions from any callable
    (artifact builds, objectives): fail the first K calls, or an explicit
    set of call numbers, then delegate.
  * ``slow_steps``      — host-side sleeps on chosen step numbers, for
    straggler-detection tests with a known ground truth.
  * ``corrupt_checkpoint`` — truncate or bit-flip a written checkpoint's
    shard / manifest, for ``latest_valid_step`` skip-torn-checkpoint tests.
  * ``nan_at_step``     — poisons one exact training step's update and loss
    with NaN on the device, with no host read, so it works on the step
    loop and inside the fused engine's CUDA graphs alike.
  * ``poison_features`` — plants non-finite / zero rows at exact indices in
    a feature matrix, the ground truth for input-firewall tests.
  * ``fail_objective_for_configs`` — scripted Hyperband objective failures
    for an exact set of configs, the ground truth for trial-quarantine
    tests.

The multi-process pieces of the reference (``KillHost``, ``launch_hosts``,
``free_port``, ``HostResult``) start processes of a multi-host job and wait
for multi-host execution (ROADMAP A11).
"""
from __future__ import annotations

import functools
import os
import signal
from typing import Any, Callable, Collection

from repro_torch.distributed.fault_tolerance import StragglerMonitor


class FaultInjected(RuntimeError):
    """Base class for every harness-raised exception."""


class TransientFault(FaultInjected):
    """An injected failure the caller is expected to retry.

    Carries the duck-typed ``transient`` marker the serving layer's
    ``RetryPolicy`` classifies on, so injecting it exercises the real
    retry path without registering harness types in production config.
    """

    transient = True


def kill_process() -> None:
    """SIGKILL the current process — no cleanup, no atexit, no flushing.

    This is what preemption / OOM-kill looks like to everything the process
    was mid-way through writing; only crash-safe state survives it.
    """
    os.kill(os.getpid(), signal.SIGKILL)


class KillAtStep(StragglerMonitor):
    """A ``StragglerMonitor`` that SIGKILLs the process at a chosen step.

    The trainer calls ``monitor.stop(global_step)`` after every step (loop
    path) or segment (fused path), so assigning ``trainer.monitor =
    KillAtStep(kill_step)`` plants a deterministic crash at the first
    boundary whose global step reaches ``kill_step`` — *before* any
    checkpoint scheduled at that boundary is written, exactly like a
    preemption landing between compute and save.
    """

    def __init__(self, kill_step: int, **monitor_kwargs: Any):
        super().__init__(**monitor_kwargs)
        self.kill_step = kill_step

    def observe(self, step: int, dt: float) -> bool:
        if step >= self.kill_step:
            kill_process()
        return super().observe(step, dt)


def flaky(
    fn: Callable[..., Any],
    *,
    failures: int,
    exc: Callable[[str], BaseException] = TransientFault,
) -> Callable[..., Any]:
    """Wrap ``fn`` to raise on its first ``failures`` calls, then delegate.

    The wrapper exposes ``calls`` (total invocations) and
    ``failures_injected`` counters for assertions.
    """
    return fail_nth_calls(fn, fail_on=range(1, failures + 1), exc=exc)


def fail_nth_calls(
    fn: Callable[..., Any],
    *,
    fail_on: Collection[int],
    exc: Callable[[str], BaseException] = TransientFault,
) -> Callable[..., Any]:
    """Wrap ``fn`` to raise on an explicit set of (1-indexed) call numbers.

    ``fail_on={3}`` lets a test crash exactly the third artifact build or
    the third hyperband rung evaluation — the deterministic analogue of "the
    job died somewhere in the middle".
    """
    fail_set = frozenset(int(n) for n in fail_on)

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        wrapper.calls += 1
        if wrapper.calls in fail_set:
            wrapper.failures_injected += 1
            raise exc(f"injected fault on call {wrapper.calls} of "
                      f"{getattr(fn, '__name__', fn)!r}")
        return fn(*args, **kwargs)

    wrapper.calls = 0
    wrapper.failures_injected = 0
    return wrapper


def slow_steps(
    train_step: Callable[..., Any],
    *,
    slow: Collection[int],
    delay: float,
) -> Callable[..., Any]:
    """Wrap a train step to sleep ``delay`` seconds before chosen calls.

    Call numbers are 1-indexed; on the fused path the wrapped step is traced
    (not called per step), so apply this on the loop path where per-step
    wall time is observable.  The sleep happens on the host before dispatch,
    which is exactly where a straggling input pipeline or a contended host
    shows up.
    """
    import time

    slow_set = frozenset(int(n) for n in slow)

    @functools.wraps(train_step)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        wrapper.calls += 1
        if wrapper.calls in slow_set:
            time.sleep(delay)
        return train_step(*args, **kwargs)

    wrapper.calls = 0
    return wrapper


def nan_at_step(
    train_step: Callable[..., Any], *, step: int
) -> Callable[..., Any]:
    """Wrap a train step so the step numbered ``step`` diverges to NaN.

    The fault fires when the *incoming* ``state.step`` counter equals
    ``step``.  The predicate is taken before the call — a step that updates
    its state in place (``updates_in_place``, carried through
    ``functools.wraps``) has advanced the counter by the time it returns —
    as a device tensor with no host read, so the fault fires at the same
    step on the step loop and inside a captured CUDA graph, and the same
    schedule replays bit-identically after a crash.  Every floating leaf of
    the new state and metrics is poisoned (a real divergence takes the
    parameters with it, not just the loss), so an unguarded run is visibly
    wrecked from this step on while a guarded run must skip or roll back.
    """
    import torch

    from repro_torch import tree as T

    target = int(step)

    @functools.wraps(train_step)
    def wrapper(state: Any, batch: Any) -> Any:
        hit = state.step == target
        new_state, metrics = train_step(state, batch)

        def nanify(x):
            if not (torch.is_tensor(x) and torch.is_floating_point(x)):
                return x
            with torch.no_grad():
                return torch.where(hit, torch.full_like(x, float("nan")), x)

        return T.map(nanify, new_state), {k: nanify(v) for k, v in metrics.items()}

    return wrapper


def poison_features(
    features: Any,
    *,
    nan_rows: Collection[int] = (),
    inf_rows: Collection[int] = (),
    zero_rows: Collection[int] = (),
) -> Any:
    """Return a copy of ``features`` with exact rows poisoned.

    ``nan_rows`` / ``inf_rows`` become all-NaN / all-inf (non-finite input),
    ``zero_rows`` become exact zero vectors (the silent ``normalize_rows``
    hazard the firewall screens for).  Indices are explicit — never sampled
    — so every firewall test has a known ground truth to assert against.
    """
    import numpy as np

    out = np.array(features, copy=True)
    if not np.issubdtype(out.dtype, np.floating):
        raise TypeError(
            f"poison_features needs a floating dtype to hold NaN/inf, "
            f"got {out.dtype}")
    for i in nan_rows:
        out[int(i)] = np.nan
    for i in inf_rows:
        out[int(i)] = np.inf
    for i in zero_rows:
        out[int(i)] = 0.0
    return out


def fail_objective_for_configs(
    objective: Callable[..., Any],
    *,
    fail_configs: Collection[dict],
    exc: Callable[[str], BaseException] = FaultInjected,
) -> Callable[..., Any]:
    """Wrap a hyperband objective to raise for an exact set of configs.

    Configs are matched structurally (``tuple(sorted(cfg.items()))``), so a
    scripted failure follows its trial through every rung it is promoted to
    — the deterministic analogue of "this hyperparameter combination always
    diverges".  The wrapper exposes ``calls`` and ``failures_injected``
    counters for assertions.
    """
    fail_set = frozenset(tuple(sorted(c.items())) for c in fail_configs)

    @functools.wraps(objective)
    def wrapper(config: dict, budget: Any) -> Any:
        wrapper.calls += 1
        if tuple(sorted(config.items())) in fail_set:
            wrapper.failures_injected += 1
            raise exc(f"injected objective failure for config {config!r}")
        return objective(config, budget)

    wrapper.calls = 0
    wrapper.failures_injected = 0
    return wrapper


#: corruption modes -> what they simulate
CORRUPTION_MODES = (
    "truncate_shard",     # crash mid shard write / lost trailing pages
    "flip_shard_byte",    # silent media corruption inside the payload
    "truncate_manifest",  # torn manifest JSON
    "delete_shard",       # shard file lost entirely
)


def corrupt_checkpoint(
    directory: str, step: int, *, mode: str = "truncate_shard"
) -> str:
    """Deterministically damage checkpoint ``step_<step>`` under ``directory``
    (the port's checkpoints keep the reference's layout: ``manifest.json``
    and ``shard_0.npz``).

    Returns the path of the file that was damaged.  Every mode must be
    caught by ``CheckpointManager.validate_step`` and skipped by
    ``latest_valid_step`` — that is the contract the fault-tolerance suite
    pins down.
    """
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; one of "
                         f"{CORRUPTION_MODES}")
    path = os.path.join(directory, f"step_{step}")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    manifest = os.path.join(path, "manifest.json")
    shards = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.startswith("shard_") and f.endswith(".npz")
    )
    if mode == "truncate_manifest":
        size = os.path.getsize(manifest)
        with open(manifest, "r+b") as f:
            f.truncate(max(1, size // 2))
        return manifest
    if not shards:
        raise FileNotFoundError(f"no shard files under {path}")
    target = shards[0]
    if mode == "delete_shard":
        os.remove(target)
    elif mode == "truncate_shard":
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "flip_shard_byte":
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            # flip a byte in the back half: inside the zip payload, past the
            # npz header, so the damage is to array bytes not file framing
            pos = max(0, size - max(1, size // 4))
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
    return target
