"""Training divergence guard: fused non-finite / loss-spike detection (port
of ``repro.health.guard``).

The guard wraps a ``(state, batch) -> (state, metrics)`` train step so the
update is *conditionally applied on the device*: when the step's loss is
non-finite (or exceeds a declared spike threshold) every state leaf keeps
its pre-step value and only the step counter advances.  The choice is a
``torch.where`` per leaf on a device flag, so it runs inside a captured
CUDA graph and costs **no host read** on the healthy path — the flag rides
the metrics (``GUARD_KEY``) that training already copies out at log
boundaries.

A step that returns a new state (the LM's ``make_train_step``) leaves the
one it was given as it was, so the guard reads that as the pre-step state:
no copy, and each new leaf is freed as soon as its guarded value exists.  A
step that updates its state in place (the session's classifier step)
declares it with a true ``updates_in_place`` attribute (``functools.wraps``
carries it through a wrapper); only then does the guard keep a copy of the
pre-step state until the flag is known, one state a step.  A step that
changes its input without declaring it raises (its tensors' version
counters moved), rather than being skipped to a state that is not the
pre-step one.

The *in-step* behaviour is always skip-semantics; the
:class:`GuardPolicy` ``action`` says what the host does when it observes
the flag (``Trainer``): ``skip_step`` nothing more; ``rollback`` restores
the newest valid checkpoint and replays, tolerating flags at or before the
rolled-back step; ``abort`` raises :class:`DivergenceError`.

Skipping still advances ``state.step``: NamedTuple and dataclass states
with a ``step`` field take the new counter; other state containers keep
skip-semantics for every leaf.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T

#: Metrics key carrying the per-step flag: 1.0 = step was skipped.
GUARD_KEY = "guard_bad"

GUARD_ACTIONS = ("skip_step", "rollback", "abort")


class DivergenceError(RuntimeError):
    """Training diverged and the guard policy said not to continue."""


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Divergence-guard configuration (hashable: part of engine cache keys).

    ``max_loss`` adds an absolute loss-spike threshold on top of the
    always-on non-finite check; ``loss_key`` names the metric guarded;
    ``max_rollbacks`` caps checkpoint restores per ``fit`` before the
    Trainer gives up with :class:`DivergenceError`.
    """

    action: str = "skip_step"
    max_loss: float | None = None
    loss_key: str = "loss"
    max_rollbacks: int = 4

    def __post_init__(self):
        if self.action not in GUARD_ACTIONS:
            raise ValueError(
                f"guard action must be one of {GUARD_ACTIONS}, "
                f"got {self.action!r}")


def _advance_counter(safe, counter):
    """Carry the new step counter onto the reverted state when possible."""
    if counter is not None:
        if hasattr(safe, "_replace"):                    # NamedTuple states
            return safe._replace(step=counter)
        if dataclasses.is_dataclass(safe):
            return dataclasses.replace(safe, step=counter)
    return safe


def guarded_step(step_fn, policy: GuardPolicy):
    """Wrap ``step_fn`` with the fused divergence check.

    Returns a step with the same signature whose metrics gain
    ``GUARD_KEY`` (0.0 healthy / 1.0 skipped).  No host read: safe inside a
    captured graph.  The pre-step state is copied only for a step whose
    ``updates_in_place`` attribute is true (see the module docstring).
    """
    in_place = bool(getattr(step_fn, "updates_in_place", False))

    def step(state, batch):
        before = T.leaves(state)
        if in_place:
            with torch.no_grad():
                before = [t.detach().clone() for t in before]
        else:
            versions = [t._version for t in before]
        new_state, metrics = step_fn(state, batch)
        if not in_place and any(t._version != v for t, v in zip(before, versions)):
            raise RuntimeError(
                f"{getattr(step_fn, '__name__', step_fn)!r} changed the state it was given in "
                "place: set its updates_in_place attribute so the guard keeps the pre-step state")
        loss = metrics[policy.loss_key]
        counter = new_state.step if hasattr(new_state, "step") else None
        new = T.leaves(new_state)
        del new_state
        with torch.no_grad():
            ok = torch.isfinite(loss)
            if policy.max_loss is not None:
                ok = torch.logical_and(ok, loss <= policy.max_loss)
            safe = []
            for i, old in enumerate(before):
                safe.append(torch.where(ok, new[i].detach(), old))
                new[i] = None   # the step's own leaf is not needed past here
        out = dict(metrics)
        out[GUARD_KEY] = 1.0 - ok.to(torch.float32)
        return _advance_counter(T.unflatten(state, safe), counter), out

    return step
