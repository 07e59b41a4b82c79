"""The twelve registered selection strategies (MILO + the paper's §4
baselines), port of ``repro.selection.selectors``:

  ============== ============================== =========================
  registry name  paper strategy                 plan weights
  ============== ============================== =========================
  milo           MILO (SGE→WRE curriculum)      uniform
  milo_fixed     MILO (Fixed)                   uniform
  milo_hier      MILO (hierarchical refine)     uniform
  milo_targeted  query FL (SMI-style targeted)  uniform
  random         RANDOM                         uniform
  adaptive_random ADAPTIVE-RANDOM               uniform
  el2n           EL2N [Paul'21]                 uniform
  selfsup_prune  prototypes [Sorscher'22]       uniform
  craig_pb       CRAIG-PB [Mirzasoleiman'20]    cluster masses (γ)
  gradmatch_pb   GRAD-MATCH-PB [Killamsetty'21] OMP coefficients
  glister        GLISTER [Killamsetty'21]       uniform
  full           FULL (no selection)            uniform
  ============== ============================== =========================

Selection logic is reused from ``repro_torch.core.milo`` and
``repro_torch.baselines.selectors``; this module adds the weighted-plan
surface, phase tags, provenance and uniform construction.  Strategies that
compute on a device take ``device`` (the card unless the caller asks for
the CPU); ``MiloSession.selector`` passes the session's.
"""
from __future__ import annotations

import dataclasses
import time
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
    # shard the feature rows over the ranks of the selection mesh
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


@dataclasses.dataclass
class EL2NConfig:
    scores: np.ndarray
    k: int
    keep: str = "hard"


@register("el2n", EL2NConfig, paper="EL2N [Paul'21]",
          doc="keep hardest/easiest k by EL2N score")
class EL2NPlanSelector(Selector):
    """Data-diet pruning by precomputed EL2N scores."""

    def __init__(self, cfg: EL2NConfig):
        self.cfg = cfg
        self._inner = legacy.EL2NSelector(cfg.scores, cfg.k, keep=cfg.keep)

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(
            self._inner.indices_for_epoch(epoch), "fixed", epoch,
            selector="el2n", keep=self.cfg.keep,
        )


@dataclasses.dataclass
class SelfSupPruneConfig:
    features: np.ndarray
    k: int
    n_prototypes: int = 10
    seed: int = 0
    device: str | torch.device = "cuda"


@register("selfsup_prune", SelfSupPruneConfig, paper="prototypes [Sorscher'22]",
          doc="k-means prototype-distance pruning")
class SelfSupPrunePlanSelector(Selector):
    """Self-supervised prototype-distance pruning (keep farthest k)."""

    def __init__(self, cfg: SelfSupPruneConfig):
        self.cfg = cfg
        self._inner = legacy.SelfSupPruneSelector(
            cfg.features, cfg.k, n_prototypes=cfg.n_prototypes, seed=cfg.seed,
            device=cfg.device,
        )

    def plan(self, epoch: int) -> SelectionPlan:
        return uniform_plan(
            self._inner.indices_for_epoch(epoch), "fixed", epoch,
            selector="selfsup_prune", seed=self.cfg.seed,
        )


# --------------------------------------------------------------------------
# model-dependent baselines (selection cost on the training critical path)
# --------------------------------------------------------------------------

class _WindowedSelector(Selector):
    """Base for R-windowed model-dependent strategies: recompute the
    (indices, weights) pair once per R-epoch window, tag plans ``adaptive``,
    and accumulate ``selection_time`` — the cost MILO amortizes away.  The
    selection functions return host indices, so the clock stops after the
    device's work."""

    name = ""

    def __init__(self, R: int):
        self.R = R
        self.selection_time = 0.0
        self._window: int | None = None
        self._idx: np.ndarray | None = None
        self._weights: np.ndarray | None = None

    def _select(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def plan(self, epoch: int) -> SelectionPlan:
        window = epoch // self.R
        if window != self._window or self._idx is None:
            t0 = time.perf_counter()
            self._idx, self._weights = self._select()
            self.selection_time += time.perf_counter() - t0
            self._window = window
        return SelectionPlan(
            self._idx, self._weights, "adaptive", epoch,
            {"selector": self.name, "window": window,
             "selection_time": self.selection_time},
        )

    def reset_cache(self) -> None:
        self._window = None


@dataclasses.dataclass
class CraigPBConfig:
    grad_fn: Callable[[], Any]
    k: int
    R: int = 10
    device: str | torch.device = "cuda"


@register("craig_pb", CraigPBConfig, paper="CRAIG-PB [Mirzasoleiman'20]",
          doc="facility-location medoids of gradient similarity; γ weights")
class CraigPBPlanSelector(_WindowedSelector):
    """Per-batch CRAIG with cluster-mass loss weights."""

    name = "craig_pb"

    def __init__(self, cfg: CraigPBConfig):
        super().__init__(cfg.R)
        self.cfg = cfg

    def _select(self):
        return legacy.craig_pb_select(self.cfg.grad_fn(), self.cfg.k, device=self.cfg.device)


@dataclasses.dataclass
class GradMatchPBConfig:
    grad_fn: Callable[[], Any]
    k: int
    R: int = 10
    lam: float = 0.5
    device: str | torch.device = "cuda"


@register("gradmatch_pb", GradMatchPBConfig, paper="GRAD-MATCH-PB [Killamsetty'21]",
          doc="OMP matching of the mean gradient; OMP-coefficient weights")
class GradMatchPBPlanSelector(_WindowedSelector):
    """Per-batch GRAD-MATCH with OMP-coefficient loss weights."""

    name = "gradmatch_pb"

    def __init__(self, cfg: GradMatchPBConfig):
        super().__init__(cfg.R)
        self.cfg = cfg

    def _select(self):
        return legacy.gradmatch_omp_select(self.cfg.grad_fn(), self.cfg.k, self.cfg.lam,
                                           device=self.cfg.device)


@dataclasses.dataclass
class GlisterConfig:
    grad_fn: Callable[[], Any]
    val_grad_fn: Callable[[], Any]
    k: int
    R: int = 10
    eta: float = 0.1
    device: str | torch.device = "cuda"


@register("glister", GlisterConfig, paper="GLISTER [Killamsetty'21]",
          doc="greedy validation-gain selection")
class GlisterPlanSelector(_WindowedSelector):
    """GLISTER's greedy validation-gain selection (uniform weights)."""

    name = "glister"

    def __init__(self, cfg: GlisterConfig):
        super().__init__(cfg.R)
        self.cfg = cfg

    def _select(self):
        idx = legacy.glister_select(
            self.cfg.grad_fn(), self.cfg.val_grad_fn(), self.cfg.k, self.cfg.eta,
            device=self.cfg.device,
        )
        return idx, np.ones(len(idx), np.float32)
