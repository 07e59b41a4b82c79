"""MILO orchestrator (paper Alg. 1): preprocessing + per-epoch subset serving.

Port of ``repro.core.milo`` on the flat by-class path:

``MiloPreprocessor.preprocess`` runs once per (dataset, k):
  1. class-wise partition of the feature matrix,
  2. per class: Gram matrix -> SGE with graph-cut (the easy-subset bank),
  3. per class: full greedy with disparity-min -> importance ->
     Taylor-softmax probabilities (WRE),
  4. merge to global indices; return a ``MiloMetadata`` artifact whose
     config (and ``config_hash``) is key-for-key the reference's.

With ``gram_free=True`` no Gram is built: the set functions of
``core.gram_free`` contract the row-normalised features directly (O(n·d)
memory).  With ``lazy_gains=True`` a facility-location WRE pass runs
through ``greedy.lazy_greedy``.

``MiloSelector`` serves the subsets during training: an SGE-bank lookup or
one Gumbel top-k WRE draw per epoch window.

Randomness: the SGE draws come from a ``torch.Generator`` seeded by
``preprocess``'s ``seed``, the WRE draws from one seeded by (seed, window).
The keyword-only seams ``sge_noise=`` (``preprocess``) and ``wre_noise=``
(``MiloSelector``) take the draws instead, which is how the parity tests
replay the reference's JAX draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import gram_free as gram_free_mod, submodular
from repro_torch.core.curriculum import CurriculumConfig
from repro_torch.core.exploration import taylor_softmax, weighted_sample_without_replacement
from repro_torch.core.greedy import greedy_importance, sge as run_sge, stochastic_candidate_count
from repro_torch.core.metadata import MiloMetadata
from repro_torch.core.partition import (
    make_partition_strategy,
    merge_class_selections,
    proportional_budgets,
)
from repro_torch.core.similarity import gram_matrix_blocked, normalize_rows
from repro_torch.device import resolve_device

#: knobs of the reference whose machinery is not ported yet:
#: field -> (the only value the port accepts, ROADMAP item that ports the rest)
UNPORTED_PREPROCESS = {
    "shard_selection": (False, "A11 (multi-device selection)"),
    "firewall": (None, "A9 (health firewall)"),
    "partition": ("by_class", "A8 (hierarchical path)"),
    "refine_factor": (1, "A8 (hierarchical path)"),
}


def refuse_unported(obj: Any, table: dict[str, tuple[Any, str]]) -> None:
    """Raise ``NotImplementedError`` for a knob set away from the one value
    the port supports, naming the ROADMAP item that will port it."""
    for name, (allowed, item) in table.items():
        val = getattr(obj, name)
        if name == "refine_factor":
            val = max(1, int(val))  # the reference treats rf <= 1 as off
        if val != allowed:
            raise NotImplementedError(
                f"{type(obj).__name__}.{name}={getattr(obj, name)!r} is not "
                f"ported yet (ROADMAP {item}); the port supports {allowed!r}"
            )


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _normalize_probs(p: np.ndarray) -> np.ndarray:
    """Normalize to a distribution; degenerate mass (all-zero or non-finite)
    falls back to uniform so WRE sampling stays well-defined."""
    p = np.where(np.isfinite(p), p, 0.0).astype(np.float32)
    p = np.maximum(p, 0.0)
    total = float(p.sum())
    if total <= 0.0:
        return np.full(p.shape, 1.0 / len(p), np.float32)
    return p / total


@dataclasses.dataclass
class MiloPreprocessor:
    """One-shot, model-agnostic pre-processing (paper §3.1-3.2).

    The fields are the reference's, with its names and defaults, so either
    package's preprocessor can be built from ``dataclasses.asdict`` of the
    other.  ``device`` is a keyword-only constructor argument, not a field:
    the artifact config and its hash stay the reference's.
    """

    subset_fraction: float = 0.1
    n_sge_subsets: int = 8
    eps: float = 0.01
    easy_fn: str = "graph_cut"
    hard_fn: str = "disparity_min"
    graph_cut_lambda: float = 0.4
    classwise: bool = True
    metric: str = "cosine"
    gram_block: int = 2048
    use_pallas: bool = False        # True: Gram tiles through the CUDA kernel
    gram_free: bool = False
    bucket_classes: bool = True
    # the bank always runs as one batch here; both values select the same
    # trajectories (as in the reference), so the knob is accepted as is
    sge_vmapped: bool = True
    shard_selection: bool = False
    lazy_gains: bool = False
    lazy_threshold: float = 0.125
    lazy_two_level: bool = False
    exact_sge_candidates: bool = False
    firewall: str | None = None
    partition: str = "by_class"
    partition_block: int = 4096
    partition_seed: int = 0
    refine_factor: int = 1
    _: dataclasses.KW_ONLY
    device: dataclasses.InitVar[str | torch.device] = "cuda"

    def __post_init__(self, device):
        refuse_unported(self, UNPORTED_PREPROCESS)
        self.device = resolve_device(device)

    def _lazy_budget(self, n_run: int, fn: submodular.SetFunction) -> int | None:
        """Touched-rows budget of the WRE full-greedy pass, or None when lazy
        gains are off, the set function has no lazy hooks, or the threshold
        would save nothing."""
        if not self.lazy_gains or fn.lazy is None:
            return None
        budget = max(1, int(n_run * self.lazy_threshold))
        return None if budget >= n_run else budget

    def _set_fn(self, name: str) -> submodular.SetFunction:
        if self.gram_free:
            if name == "graph_cut":
                return gram_free_mod.make_gram_free_graph_cut(self.graph_cut_lambda)
            if name == "facility_location":
                # the kernels on a CUDA device, their plain versions on the CPU
                return gram_free_mod.make_gram_free_facility_location(
                    use_pallas=self.use_pallas)
            return gram_free_mod.get_gram_free(name)
        if name == "graph_cut":
            return submodular.make_graph_cut(self.graph_cut_lambda)
        return submodular.get(name)

    def _class_selection(
        self,
        feats_c: np.ndarray,
        k_c: int,
        *,
        bucket: bool,
        easy: submodular.SetFunction,
        hard: submodular.SetFunction,
        generator: torch.Generator,
        noise=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """SGE bank + WRE importance for one class: the (n_sge_subsets, k_c)
        local-index bank and the (n_c,) importance vector."""
        n_c = len(feats_c)
        z = torch.as_tensor(feats_c, device=self.device)
        n_run, k_run, valid = n_c, k_c, None
        if bucket:
            # pad the problem (ground set AND budget) to the next power of
            # two, as the reference does to share compiled programs; the
            # masking is exact, and the stochastic draws use the padded
            # geometry, so trajectories match the reference's bucketed run
            n_run = _next_pow2(n_c)
            k_run = min(n_run, _next_pow2(k_c))
            valid = torch.arange(n_run, device=self.device) < n_c
        if self.gram_free:
            # the "kernel" the engines take is the row-normalised features,
            # zero rows past n_c (the padding sentinel): O(n·d), no Gram
            A = torch.zeros((n_run, z.shape[1]), dtype=torch.float32, device=self.device)
            A[:n_c] = normalize_rows(z.float())
        else:
            A = gram_matrix_blocked(z, metric=self.metric, block=self.gram_block,
                                    use_pallas=self.use_pallas, n_pad=n_run)
        s_sge = (stochastic_candidate_count(n_c, k_c, self.eps)
                 if self.exact_sge_candidates else None)
        subs = run_sge(easy, A, k_run, n_subsets=self.n_sge_subsets, eps=self.eps,
                       valid=valid, s=s_sge, generator=generator, noise=noise)
        imp = greedy_importance(hard, A, valid=valid,
                                lazy_budget=self._lazy_budget(n_run, hard),
                                lazy_two_level=self.lazy_two_level)
        return (subs[:, :k_c].cpu().numpy().astype(np.int64),
                imp[:n_c].cpu().numpy().astype(np.float32))

    def preprocess(
        self,
        features: np.ndarray,
        labels: np.ndarray | None,
        seed: int = 0,
        *,
        encoder_id: str = "precomputed",
        prep_seed: int | None = None,
        sge_noise: Sequence[Any] | None = None,
    ) -> MiloMetadata:
        """Build the artifact.  ``seed`` seeds the SGE draws' generator on the
        device; ``prep_seed`` is provenance only (recorded in the config).

        ``sge_noise[i]`` (keyword-only) replaces the Gumbel draws of the
        i-th partition (classes in ascending label order): an
        (n_sge_subsets, k_run, n_run) array in the run's (bucketed) geometry.
        """
        features = np.asarray(features)
        if self.gram_free and self.metric != "cosine":
            raise ValueError(
                f"gram_free preprocessing supports metric='cosine' only (got "
                f"{self.metric!r}); the gram-free set functions rebuild "
                "rescaled-cosine columns from features on the fly")
        m = features.shape[0]
        k = max(1, int(round(self.subset_fraction * m)))
        labels_arr = (np.zeros((m,), np.int64) if labels is None
                      else np.asarray(labels, np.int64))
        strategy = make_partition_strategy(self.partition)
        parts = strategy.partition(
            None if labels is None or not self.classwise else labels_arr, m)
        budgets = proportional_budgets(parts, k)
        easy = self._set_fn(self.easy_fn)
        hard = self._set_fn(self.hard_fn)
        # bucketing only deduplicates across >1 partition (as the reference)
        bucket = self.bucket_classes and len(parts) > 1
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        per_class_sge: list[np.ndarray] = []
        wre_probs = np.zeros((m,), np.float32)
        wre_importance = np.zeros((m,), np.float32)
        for i, (part, k_c) in enumerate(zip(parts, budgets)):
            n_c = len(part.indices)
            if k_c <= 0:
                per_class_sge.append(np.zeros((self.n_sge_subsets, 0), np.int64))
                imp = np.zeros((n_c,), np.float32)
            else:
                subs_c, imp = self._class_selection(
                    features[part.indices], k_c, bucket=bucket, easy=easy, hard=hard,
                    generator=gen, noise=None if sge_noise is None else sge_noise[i],
                )
                per_class_sge.append(subs_c)
            wre_importance[part.indices] = imp
            # within-class Taylor-softmax, weighted by class mass so the
            # global vector is a distribution with stratified expectation
            p_local = taylor_softmax(torch.from_numpy(imp)).numpy()
            wre_probs[part.indices] = p_local * (n_c / m)

        wre_probs = _normalize_probs(wre_probs)
        sge_subsets = np.stack(
            [merge_class_selections(parts, [s[i] for s in per_class_sge])
             for i in range(self.n_sge_subsets)], axis=0)
        config = dict(
            subset_fraction=self.subset_fraction,
            k=int(sge_subsets.shape[1]),
            n_sge_subsets=self.n_sge_subsets,
            eps=self.eps,
            easy_fn=self.easy_fn,
            hard_fn=self.hard_fn,
            graph_cut_lambda=self.graph_cut_lambda,
            classwise=self.classwise,
            metric=self.metric,
            gram_free=self.gram_free,
            bucket_classes=self.bucket_classes,
            lazy_gains=self.lazy_gains,
            lazy_threshold=self.lazy_threshold,
            lazy_two_level=self.lazy_two_level,
            exact_sge_candidates=self.exact_sge_candidates,
            shard_selection=self.shard_selection,
            encoder_id=encoder_id,
            prep_seed=prep_seed,
        )
        return MiloMetadata(
            sge_subsets=sge_subsets,
            wre_probs=wre_probs,
            wre_importance=wre_importance,
            class_labels=labels_arr,
            class_budgets=np.asarray(budgets, np.int64),
            config=config,
        )


def _window_seed(seed: int, window: int) -> int:
    """Generator seed of one WRE window: a pure function of (seed, window)."""
    return int(np.random.SeedSequence([int(seed), int(window)]).generate_state(1)[0])


@dataclasses.dataclass
class MiloSelector:
    """Per-epoch subset server driven by the curriculum (paper Alg. 1).

    ``wre_noise(window)`` (keyword-only) returns the (m,) Gumbel draws of a
    WRE window in place of the seeded generator's.
    """

    metadata: MiloMetadata
    curriculum: CurriculumConfig
    seed: int = 0
    _: dataclasses.KW_ONLY
    device: dataclasses.InitVar[str | torch.device] = "cuda"
    wre_noise: Callable[[int], Any] | None = None

    def __post_init__(self, device):
        self.device = resolve_device(device)
        self._probs: torch.Tensor | None = None
        self._cache_epoch: int = -1
        self._cache: np.ndarray | None = None

    @property
    def k(self) -> int:
        return self.metadata.k

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        """Subset (global indices) for ``epoch``; deterministic in (seed, epoch)."""
        if epoch == self._cache_epoch and self._cache is not None:
            return self._cache
        cur = self.curriculum
        if cur.phase(epoch) == "sge":
            slot = (epoch // cur.R) % self.metadata.sge_subsets.shape[0]
            idx = self.metadata.sge_subsets[slot]
        else:
            # one fresh WRE draw per R-epoch window, keyed by (seed, window)
            window = (epoch - cur.sge_epochs) // cur.R
            if self._probs is None:
                self._probs = torch.as_tensor(self.metadata.wre_probs, device=self.device)
            noise = None if self.wre_noise is None else self.wre_noise(window)
            gen = None
            if noise is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    _window_seed(self.seed, window))
            idx = weighted_sample_without_replacement(
                self._probs, self.k, generator=gen, noise=noise,
            ).cpu().numpy().astype(np.int64)
        self._cache_epoch, self._cache = epoch, idx
        return idx
