"""Easy-to-hard curriculum schedule (paper §3.1.3 / Alg. 1).

Epochs [0, kappa*T) train on SGE(graph-cut) subsets — representative, "easy".
Epochs [kappa*T, T) train on WRE(disparity-min) samples — diverse, "hard",
with easy samples still drawn occasionally (mitigates forgetting).
A new subset is taken every R epochs (paper finds R = 1 best).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Phase = Literal["sge", "wre"]


@dataclasses.dataclass(frozen=True)
class CurriculumConfig:
    total_epochs: int
    kappa: float = 1.0 / 6.0  # fraction of epochs on SGE (paper-tuned optimum)
    R: int = 1                # re-selection interval in epochs

    def __post_init__(self):
        if not (0.0 <= self.kappa <= 1.0):
            raise ValueError(f"kappa must be in [0,1], got {self.kappa}")
        if self.R < 1:
            raise ValueError("R must be >= 1")

    @property
    def sge_epochs(self) -> int:
        return int(round(self.kappa * self.total_epochs))

    def phase(self, epoch: int) -> Phase:
        return "sge" if epoch < self.sge_epochs else "wre"

    def needs_new_subset(self, epoch: int) -> bool:
        """True when a fresh subset must be materialized at this epoch."""
        if epoch == 0 or epoch == self.sge_epochs:
            return True  # phase boundary always re-selects
        if self.phase(epoch) == "sge":
            return epoch % self.R == 0
        return (epoch - self.sge_epochs) % self.R == 0
