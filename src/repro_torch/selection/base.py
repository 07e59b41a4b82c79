"""``Selector`` ABC — the selection protocol every strategy implements
(port of ``repro.selection.base``).

Every strategy implements ``plan(epoch) -> SelectionPlan``.  The old
``indices_for_epoch`` entry point survives as a deprecation shim on the ABC,
and ``ensure_selector`` adapts objects that speak only the old protocol —
the legacy selectors of ``repro_torch.baselines.selectors``,
``core.milo.MiloSelector`` and ``data.pipeline.FullSelector`` — so a
``Pipeline`` trains on them as the reference's does.
"""
from __future__ import annotations

import abc
import warnings
from typing import Any

import numpy as np

from repro_torch.selection.plan import SelectionPlan, uniform_plan


class Selector(abc.ABC):
    """Per-epoch subset server.  Implementations must be deterministic in
    (their configured seed, epoch) so restarts replay the same data order."""

    @abc.abstractmethod
    def plan(self, epoch: int) -> SelectionPlan:
        """The subset (indices + weights + phase + provenance) for ``epoch``."""

    def reset_cache(self) -> None:
        """Drop any memoized plans."""

    # -- deprecation shim ---------------------------------------------------
    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        """Deprecated: use ``plan(epoch).indices``."""
        warnings.warn(
            "indices_for_epoch is deprecated; use plan(epoch).indices",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.plan(epoch).indices


class LegacySelectorAdapter(Selector):
    """Wraps an object exposing only ``indices_for_epoch`` into the plan
    protocol with uniform weights.

    The phase is inferred from the wrapped object: a ``curriculum``
    attribute gives its sge/wre phase (``MiloSelector``), an ``R``
    re-selection interval gives ``adaptive``, anything else ``fixed``."""

    def __init__(self, legacy: Any):
        if not hasattr(legacy, "indices_for_epoch"):
            raise TypeError(
                f"{type(legacy).__name__} implements neither plan() nor "
                "indices_for_epoch()"
            )
        self.legacy = legacy

    def _phase(self, epoch: int) -> str:
        curriculum = getattr(self.legacy, "curriculum", None)
        if curriculum is not None and hasattr(curriculum, "phase"):
            return curriculum.phase(epoch)
        if getattr(self.legacy, "R", None):
            return "adaptive"
        return "fixed"

    def plan(self, epoch: int) -> SelectionPlan:
        idx = np.asarray(self.legacy.indices_for_epoch(epoch), np.int64)
        return uniform_plan(
            idx, self._phase(epoch), epoch, adapter=type(self.legacy).__name__
        )

    def reset_cache(self) -> None:
        if hasattr(self.legacy, "_cache_epoch"):
            self.legacy._cache_epoch = -1


def ensure_selector(obj: Any) -> Selector:
    """Coerce ``obj`` to the plan protocol (identity for new-style selectors)."""
    if isinstance(obj, Selector) or hasattr(obj, "plan"):
        return obj
    return LegacySelectorAdapter(obj)
