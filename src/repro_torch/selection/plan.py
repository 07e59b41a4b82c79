"""``SelectionPlan``: the unit of exchange between selectors and consumers
(a copy of ``repro.selection.plan``; numpy only).

A plan is everything a training loop needs for one epoch of subset training:
the sample indices, a per-sample loss weight aligned with them (uniform for
unweighted strategies; CRAIG's cluster masses and GRAD-MATCH's OMP
coefficients otherwise), the curriculum phase that produced it, and enough
provenance to reproduce the draw.  Replaces the bare index arrays of the old
``indices_for_epoch`` protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

#: Curriculum phases a plan may carry.
#:   sge      — easy subset from the pre-computed SGE bank (MILO warm-up)
#:   wre      — fresh weighted-random-exploration draw (MILO main phase)
#:   fixed    — one subset reused every epoch (RANDOM, EL2N, MILO-Fixed, ...)
#:   adaptive — re-selected every R epochs (ADAPTIVE-RANDOM, CRAIG-PB, ...)
PHASES = ("sge", "wre", "fixed", "adaptive")


@dataclasses.dataclass(frozen=True)
class SelectionPlan:
    """Immutable per-epoch selection decision."""

    indices: np.ndarray                 # (k,) int64 global sample indices
    weights: np.ndarray                 # (k,) float32 loss weights, mean ~= 1
    phase: str                          # one of PHASES
    epoch: int
    provenance: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        idx = np.asarray(self.indices, np.int64).reshape(-1)
        object.__setattr__(self, "indices", idx)
        if self.weights is None:
            w = np.ones(idx.shape, np.float32)
        else:
            w = np.asarray(self.weights, np.float32).reshape(-1)
        if w.shape != idx.shape:
            raise ValueError(
                f"weights shape {w.shape} does not match indices shape {idx.shape}"
            )
        object.__setattr__(self, "weights", w)
        if self.phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {self.phase!r}")

    @property
    def k(self) -> int:
        return int(self.indices.shape[0])

    def validate(self, n: int) -> "SelectionPlan":
        """Check the plan is a well-formed subset of range(n); returns self."""
        if self.k and (self.indices.min() < 0 or self.indices.max() >= n):
            raise ValueError(f"plan indices out of range for dataset of size {n}")
        if len(np.unique(self.indices)) != self.k:
            raise ValueError("plan indices contain duplicates")
        if not np.isfinite(self.weights).all() or (self.weights < 0).any():
            raise ValueError("plan weights must be finite and non-negative")
        return self


def uniform_plan(
    indices: np.ndarray, phase: str, epoch: int, **provenance: Any
) -> SelectionPlan:
    """Plan with unit weights (the common case for unweighted strategies)."""
    idx = np.asarray(indices, np.int64)
    return SelectionPlan(idx, np.ones(idx.shape, np.float32), phase, epoch, provenance)
