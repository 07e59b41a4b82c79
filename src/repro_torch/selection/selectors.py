"""The ported selection strategies: ``milo``, ``milo_fixed``, ``milo_hier``,
``milo_targeted``, ``full``, ``random`` and ``adaptive_random`` (port of
``repro.selection.selectors``).

The other names of the reference's registry raise ``KeyError`` through
``registry.selector_entry`` until their slice lands (see ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.baselines import selectors as legacy
from repro_torch.core.curriculum import CurriculumConfig
from repro_torch.core.metadata import MiloMetadata
from repro_torch.core.milo import MiloSelector, hierarchical_select, targeted_select
from repro_torch.selection.base import Selector
from repro_torch.selection.plan import SelectionPlan, uniform_plan
from repro_torch.selection.registry import register


@dataclasses.dataclass
class MiloConfig:
    metadata: MiloMetadata | None = None
    metadata_path: str | None = None
    total_epochs: int = 40
    kappa: float = 1.0 / 6.0
    R: int = 1
    seed: int = 0
    expected_config: dict | None = None
    expected_hash: str | None = None
    # where the WRE draws run, and the draw seam (see core.milo.MiloSelector)
    device: str | torch.device = "cuda"
    wre_noise: Callable[[int], Any] | None = None

    def resolve_metadata(self) -> MiloMetadata:
        if self.metadata is not None:
            return self.metadata
        if self.metadata_path is not None:
            return MiloMetadata.load(
                self.metadata_path,
                expected_config=self.expected_config,
                expected_hash=self.expected_hash,
            )
        raise ValueError("milo selector needs `metadata` or `metadata_path`")


@register("milo", MiloConfig, paper="MILO",
          doc="easy-to-hard curriculum over precomputed SGE bank + WRE draws")
class MiloPlanSelector(Selector):
    """MILO curriculum: SGE-bank lookups early, WRE Gumbel draws after —
    per-epoch cost O(k), independent of the model (paper Alg. 1)."""

    def __init__(self, cfg: MiloConfig):
        self.cfg = cfg
        self.metadata = cfg.resolve_metadata()
        self.curriculum = CurriculumConfig(
            total_epochs=cfg.total_epochs, kappa=cfg.kappa, R=cfg.R
        )
        self._inner = MiloSelector(self.metadata, self.curriculum, seed=cfg.seed,
                                   device=cfg.device, wre_noise=cfg.wre_noise)
        self._config_hash = self.metadata.config_hash()

    @property
    def k(self) -> int:
        return self.metadata.k

    def plan(self, epoch: int) -> SelectionPlan:
        idx = self._inner.indices_for_epoch(epoch)
        phase = self.curriculum.phase(epoch)
        if phase == "sge":
            window = (epoch // self.curriculum.R) % self.metadata.sge_subsets.shape[0]
        else:
            window = (epoch - self.curriculum.sge_epochs) // self.curriculum.R
        return uniform_plan(
            idx, phase, epoch,
            selector="milo", seed=self.cfg.seed, window=int(window),
            config_hash=self._config_hash,
        )

    def reset_cache(self) -> None:
        self._inner._cache_epoch = -1


@dataclasses.dataclass
class MiloFixedConfig:
    features: np.ndarray
    k: int
    # select over features directly (O(n·d) memory) instead of the (n,n) Gram
    gram_free: bool = False
    # shard the feature rows over all local devices (not ported: ROADMAP A11)
    shard_selection: bool = False
    # where the greedy runs (see baselines.MiloFixedSelector)
    device: str | torch.device = "cuda"


@register("milo_fixed", MiloFixedConfig, paper="MILO (Fixed)",
          doc="fixed disparity-min subset over frozen-encoder features")
class MiloFixedPlanSelector(Selector):
    """One fixed subset maximizing disparity-min (no curriculum)."""

    def __init__(self, cfg: MiloFixedConfig):
        self.cfg = cfg
        self._inner = legacy.MiloFixedSelector(
            cfg.features, cfg.k, gram_free=cfg.gram_free,
            shard_selection=cfg.shard_selection, device=cfg.device,
        )

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(
            self._inner.indices_for_epoch(epoch), "fixed", epoch, selector="milo_fixed"
        )


@dataclasses.dataclass
class MiloHierConfig:
    features: np.ndarray
    k: int
    # None → unsupervised partitioning (random_blocks / single block)
    labels: np.ndarray | None = None
    # "by_class" | "random_blocks" | "balanced_blocks"
    partition: str = "random_blocks"
    partition_block: int = 4096
    partition_seed: int = 0
    # level-0 oversampling: each partition keeps min(n_c, refine_factor·k_c)
    refine_factor: int = 2
    fn_name: str = "facility_location"
    gram_free: bool = True
    # where both levels' greedy runs (the plain route, as in the reference)
    device: str | torch.device = "cuda"


@register("milo_hier", MiloHierConfig, paper="MILO (hierarchical)",
          doc="two-level partition→greedy→refine subset; partition-sized memory")
class MiloHierPlanSelector(Selector):
    """One fixed subset from the hierarchical partition-then-refine pipeline
    (per-partition greedy + level-1 refine; partition-sized peak memory)."""

    def __init__(self, cfg: MiloHierConfig):
        self.cfg = cfg
        self._idx, self.info = hierarchical_select(
            cfg.features, cfg.k, labels=cfg.labels, partition=cfg.partition,
            block_size=cfg.partition_block, seed=cfg.partition_seed,
            refine_factor=cfg.refine_factor, fn_name=cfg.fn_name,
            gram_free=cfg.gram_free, return_info=True, device=cfg.device,
        )

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(
            self._idx, "fixed", epoch, selector="milo_hier",
            partition=self.cfg.partition, refine_factor=self.cfg.refine_factor,
        )


@dataclasses.dataclass
class MiloTargetedConfig:
    features: np.ndarray
    queries: np.ndarray
    k: int
    labels: np.ndarray | None = None
    partition: str = "by_class"
    partition_block: int = 4096
    partition_seed: int = 0
    refine_factor: int = 4
    device: str | torch.device = "cuda"


@register("milo_targeted", MiloTargetedConfig, paper="query FL (SMI)",
          doc="query-conditioned targeted selection over partition winners")
class MiloTargetedPlanSelector(Selector):
    """Fixed query-covering subset: query facility location at both levels,
    so the plan covers the query slice rather than the whole ground set."""

    def __init__(self, cfg: MiloTargetedConfig):
        self.cfg = cfg
        self._idx, self.info = targeted_select(
            cfg.features, cfg.queries, cfg.k, labels=cfg.labels,
            partition=cfg.partition, block_size=cfg.partition_block,
            seed=cfg.partition_seed, refine_factor=cfg.refine_factor,
            return_info=True, device=cfg.device,
        )

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(
            self._idx, "fixed", epoch, selector="milo_targeted",
            partition=self.cfg.partition, refine_factor=self.cfg.refine_factor,
        )


@dataclasses.dataclass
class FullConfig:
    n: int


@register("full", FullConfig, paper="FULL", doc="no selection — every sample, every epoch")
class FullPlanSelector(Selector):
    """The whole dataset every epoch (skyline / no-selection baseline)."""

    def __init__(self, cfg: FullConfig):
        self.cfg = cfg

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(
            np.arange(self.cfg.n, dtype=np.int64), "fixed", epoch, selector="full"
        )


@dataclasses.dataclass
class RandomConfig:
    n: int
    k: int
    seed: int = 0


@register("random", RandomConfig, paper="RANDOM", doc="one fixed random subset")
class RandomPlanSelector(Selector):
    """Fixed random subset drawn once at construction (the reference's
    numpy draw, so both packages pick the same subset)."""

    def __init__(self, cfg: RandomConfig):
        self.cfg = cfg
        self._idx = np.random.default_rng(cfg.seed).choice(cfg.n, size=cfg.k, replace=False)

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(self._idx, "fixed", epoch, selector="random", seed=self.cfg.seed)


@dataclasses.dataclass
class AdaptiveRandomConfig:
    n: int
    k: int
    R: int = 1
    seed: int = 0


@register("adaptive_random", AdaptiveRandomConfig, paper="ADAPTIVE-RANDOM",
          doc="fresh random subset every R epochs")
class AdaptiveRandomPlanSelector(Selector):
    """Fresh random subset every R epochs, deterministic in (seed, window)
    with the reference's numpy draw."""

    def __init__(self, cfg: AdaptiveRandomConfig):
        self.cfg = cfg

    def plan(self, epoch: int) -> SelectionPlan:
        window = epoch // self.cfg.R
        rng = np.random.default_rng(self.cfg.seed * 7919 + window)
        idx = rng.choice(self.cfg.n, size=self.cfg.k, replace=False)
        return uniform_plan(idx, "adaptive", epoch, selector="adaptive_random",
                            seed=self.cfg.seed, window=window)
