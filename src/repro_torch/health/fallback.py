"""Degraded-mode selection: walk a declared fallback chain on failure (port
of ``repro.health.fallback``).

MILO's selectors assume well-conditioned geometry: a WRE draw needs ``k``
nonzero-probability rows, greedy gains need non-degenerate similarity
structure.  When that fails the exception would end the whole training run,
although a serviceable degraded answer (``adaptive_random`` over the same
budget) exists.

:class:`FallbackSelector` wraps an ordered chain of ``(name, factory)``
pairs implementing the ``Selector`` protocol.  Each ``plan(epoch)`` call
uses the first selector in the chain that (a) constructs, (b) returns a
plan without raising degenerate-math errors, and (c) returns finite
weights.  Every hop is recorded in ``events`` and stamped into the
returned plan's provenance (``fallback_from`` / ``fallback_selector``) so
a degraded run is auditable, never silent.

Only *degenerate-math* failures trigger fallback (``ValueError``,
``FloatingPointError``, ``ZeroDivisionError``, and the explicit
:class:`SelectionDegenerateError`).  Two kinds of ``ValueError`` are
excluded and propagate: ``MetadataMismatchError`` (loading the wrong
artifact is a configuration bug) and every error of the kernel layer
(``kernels._build.KernelError``: a failed build or launch, a wrapper's
refusal of its inputs, and the card's own CUDA errors) — degrading around
them would hide a kernel that never ran behind a plan that looks healthy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.metadata import MetadataMismatchError
from repro_torch.kernels._build import is_kernel_fault

#: Exception types treated as "the math is degenerate, try the next tier".
DEGENERATE_EXCS = (ValueError, FloatingPointError, ZeroDivisionError)


class SelectionDegenerateError(ValueError):
    """Explicit signal that a selector hit degenerate geometry."""


class FallbackExhaustedError(RuntimeError):
    """Every selector in the fallback chain failed."""


def _degenerate(exc: BaseException) -> bool:
    """A failure the chain may degrade around (see the module docstring)."""
    return (isinstance(exc, DEGENERATE_EXCS)
            and not isinstance(exc, MetadataMismatchError)
            and not is_kernel_fault(exc))


class FallbackSelector:
    """``Selector`` that degrades down a declared chain instead of crashing.

    ``chain`` is an ordered sequence of ``(name, factory)`` pairs; each
    factory is a zero-arg callable returning a built selector.  Factories
    run lazily — the fallback tiers cost nothing unless reached.  Once the
    chain advances past a selector it never goes back (a degenerate
    primary stays degenerate for the run), which also keeps repeat runs
    bit-identical: the same failures happen at the same points.
    """

    def __init__(self, chain: Sequence[tuple[str, Callable[[], Any]]]):
        if not chain:
            raise ValueError("fallback chain must name at least one selector")
        self.chain = list(chain)
        self.events: list[dict[str, Any]] = []
        self._pos = 0
        self._sel: Any = None

    @property
    def active_name(self) -> str:
        return self.chain[self._pos][0]

    def _advance(self, stage: str, exc: BaseException) -> None:
        self.events.append({
            "selector": self.chain[self._pos][0],
            "stage": stage,
            "error": repr(exc),
        })
        self._pos += 1
        self._sel = None
        if self._pos >= len(self.chain):
            raise FallbackExhaustedError(
                "every selector in the fallback chain failed: "
                + "; ".join(f"{e['selector']}({e['stage']}): {e['error']}"
                            for e in self.events)) from exc

    def _current(self) -> Any:
        while self._sel is None:
            _, factory = self.chain[self._pos]
            try:
                self._sel = factory()
            except DEGENERATE_EXCS as e:
                if not _degenerate(e):
                    raise                  # config bug or kernel fault
                self._advance("build", e)
        return self._sel

    def plan(self, epoch: int):
        while True:
            sel = self._current()
            try:
                plan = sel.plan(epoch)
            except DEGENERATE_EXCS as e:
                if not _degenerate(e):
                    raise
                self._advance("plan", e)
                continue
            if not np.isfinite(np.asarray(plan.weights)).all():
                self._advance("plan", SelectionDegenerateError(
                    "plan weights are non-finite"))
                continue
            if self._pos > 0:
                plan = dataclasses.replace(plan, provenance={
                    **dict(plan.provenance),
                    "fallback_from": self.chain[0][0],
                    "fallback_selector": self.chain[self._pos][0],
                    "fallback_events": [dict(e) for e in self.events],
                })
            return plan

    def reset_cache(self) -> None:
        sel = self._sel
        if sel is not None and hasattr(sel, "reset_cache"):
            sel.reset_cache()
