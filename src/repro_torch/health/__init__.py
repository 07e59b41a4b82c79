"""Numerical-health guardrails (port of ``repro.health``): so far the
divergence guard fused inside the training step (``health.guard``) and the
``GuardPolicy`` saying what to do about it — ``skip_step`` / ``rollback`` /
``abort``.  The feature firewall, the selector fallback chains and the
circuit breaker are not ported yet (ROADMAP A9b): the session's
``firewall`` and ``selector_fallback`` knobs refuse.
"""
from repro_torch.health.guard import (
    GUARD_ACTIONS,
    GUARD_KEY,
    DivergenceError,
    GuardPolicy,
    guarded_step,
)

__all__ = [
    "DivergenceError",
    "GUARD_ACTIONS",
    "GUARD_KEY",
    "GuardPolicy",
    "guarded_step",
]
