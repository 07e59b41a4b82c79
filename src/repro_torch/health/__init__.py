"""Numerical-health guardrails (port of ``repro.health``).

* :mod:`repro_torch.health.firewall` — ``validate_features`` screens the
  ground set before any selection math (non-finite rows, zero-norm
  embeddings, duplicate/constant features, degenerate class geometry) and
  produces a :class:`DataHealthReport` stamped into the artifact's config.
  Policies: ``raise`` / ``repair`` / ``quarantine``.
* :mod:`repro_torch.health.guard` — the divergence guard fused inside the
  training step (no host read on the healthy path, a CUDA graph on the
  fused path) and the :class:`GuardPolicy` saying what to do about it:
  ``skip_step`` / ``rollback`` / ``abort``.
* :mod:`repro_torch.health.fallback` — degraded-mode selection: a declared
  selector chain (e.g. ``milo`` → ``adaptive_random``) walked on
  degenerate math, every hop recorded in plan provenance; kernel faults
  are never degraded around.
* :mod:`repro_torch.health.breaker` — a per-key circuit breaker so a
  deterministically failing artifact build fails fast instead of being
  retried again and again.
"""
from repro_torch.health.breaker import CircuitBreaker, CircuitOpenError
from repro_torch.health.fallback import (
    FallbackExhaustedError,
    FallbackSelector,
    SelectionDegenerateError,
)
from repro_torch.health.firewall import (
    FIREWALL_POLICIES,
    DataHealthError,
    DataHealthReport,
    validate_features,
)
from repro_torch.health.guard import (
    GUARD_ACTIONS,
    GUARD_KEY,
    DivergenceError,
    GuardPolicy,
    guarded_step,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "DataHealthError",
    "DataHealthReport",
    "DivergenceError",
    "FIREWALL_POLICIES",
    "FallbackExhaustedError",
    "FallbackSelector",
    "GUARD_ACTIONS",
    "GUARD_KEY",
    "GuardPolicy",
    "SelectionDegenerateError",
    "guarded_step",
    "validate_features",
]
