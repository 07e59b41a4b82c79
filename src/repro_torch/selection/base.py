"""``Selector`` ABC — the selection protocol every strategy implements
(port of ``repro.selection.base``; the port has no legacy
``indices_for_epoch``-only selectors, so no adapter is needed)."""
from __future__ import annotations

import abc

from repro_torch.selection.plan import SelectionPlan


class Selector(abc.ABC):
    """Per-epoch subset server.  Implementations must be deterministic in
    (their configured seed, epoch) so restarts replay the same data order."""

    @abc.abstractmethod
    def plan(self, epoch: int) -> SelectionPlan:
        """The subset (indices + weights + phase + provenance) for ``epoch``."""

    def reset_cache(self) -> None:
        """Drop any memoized plans."""
