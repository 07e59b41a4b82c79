"""MILO orchestrator (paper Alg. 1): preprocessing + per-epoch subset serving.

Port of ``repro.core.milo``:

``MiloPreprocessor.preprocess`` runs once per (dataset, k):
  1. partition of the feature matrix (``core.partition``: by class, the
     paper's split and the default, or into bounded blocks),
  2. per partition: Gram matrix -> SGE with graph-cut (the easy-subset
     bank), oversampled to ``min(n_c, refine_factor·k_c)`` rows a slot,
  3. per partition: full greedy with disparity-min -> importance ->
     Taylor-softmax probabilities (WRE),
  4. merge to global indices; with ``refine_factor > 1`` each bank slot's
     union is cut back to k by a level-1 greedy (``greedy.refine``);
     return a ``MiloMetadata`` artifact whose config (and ``config_hash``)
     is key-for-key the reference's.  Partition provenance is stamped only
     off the flat path (``by_class`` with ``refine_factor == 1``), so flat
     hashes do not move.

With ``gram_free=True`` no Gram is built: the set functions of
``core.gram_free`` contract the row-normalised features directly (O(n·d)
memory).  With ``lazy_gains=True`` a facility-location WRE pass runs
through ``greedy.lazy_greedy``.

``MiloSelector`` serves the subsets during training: an SGE-bank lookup or
one Gumbel top-k WRE draw per epoch window.

``hierarchical_select`` and ``targeted_select`` are the one-shot two-level
selections (deterministic greedy inside every partition, then a refine over
the union of winners) behind the ``milo_hier`` and ``milo_targeted``
selectors; peak memory follows the partition size, not the ground set's.

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
from repro_torch.core.greedy import (
    greedy,
    greedy_importance,
    refine as run_refine,
    sge as run_sge,
    stochastic_candidate_count,
)
from repro_torch.core.metadata import MiloMetadata
from repro_torch.core.partition import (
    Partition,
    PartitionStrategy,
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
}


def refuse_unported(obj: Any, table: dict[str, tuple[Any, str]]) -> None:
    """Raise ``NotImplementedError`` for a knob set away from the one value
    the port supports, naming the ROADMAP item that will port it."""
    for name, (allowed, item) in table.items():
        if getattr(obj, name) != allowed:
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

    def partition_strategy(self) -> PartitionStrategy:
        """The level-0 decomposition this preprocessor applies."""
        return make_partition_strategy(
            self.partition, block_size=self.partition_block, seed=self.partition_seed)

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

    def _refine_indices(self, feats_u: np.ndarray, k: int,
                        easy: submodular.SetFunction) -> np.ndarray:
        """Level-1 pass: exact greedy (the easy_fn objective) over the union
        of level-0 winners, lazy-routed like the WRE pass, on the device
        (the dense route builds the union's Gram through ``gram_matrix_blocked``,
        so ``use_pallas`` sends it to the similarity kernel).  Returns local
        indices into ``feats_u``."""
        z = torch.as_tensor(feats_u, device=self.device)
        n_u = z.shape[0]
        if self.gram_free:
            A = normalize_rows(z.float())
        else:
            A = gram_matrix_blocked(z, metric=self.metric, block=self.gram_block,
                                    use_pallas=self.use_pallas)
        res = run_refine(easy, A, k, lazy_budget=self._lazy_budget(n_u, easy),
                         two_level=self.lazy_two_level)
        return res.indices.cpu().numpy().astype(np.int64)

    def _refine_bank(
        self,
        features: np.ndarray,
        parts: Sequence[Partition],
        per_class_sge: Sequence[np.ndarray],
        k: int,
        easy: submodular.SetFunction,
    ) -> np.ndarray:
        """Cut each oversampled bank slot back down to exactly k.  Every
        slot's union has the same size, Σ min(n_c, rf·k_c)."""
        slots = []
        for i in range(self.n_sge_subsets):
            union = merge_class_selections(parts, [s[i] for s in per_class_sge])
            if len(union) <= k:
                slots.append(union)
                continue
            slots.append(union[self._refine_indices(features[union], k, easy)])
        return np.stack(slots, axis=0)

    def warmup(self, buckets: Sequence[tuple[int, int]], d: int, *, seed: int = 0) -> int:
        """Replay the selection path on dummy features for the given
        partition geometries, discarding the outputs.

        ``buckets`` holds the true per-partition ``(n_c, k_c)`` shapes an
        upcoming ``preprocess`` will see; ``d`` is the feature width.  Each
        distinct ``(n_c, min(n_c, rf·k_c))`` pair runs the whole
        per-partition path (bucketing, masking, engine routing,
        Taylor-softmax), and with ``refine_factor > 1`` the level-1 refine
        runs once at the union's geometry.  On the card this loads the
        kernel library and warms the caching allocator before
        ``preprocess``; it captures no graph (the engines are Python loops,
        ROADMAP A3).  Returns the number of partition geometries run, the
        reference's count for the same ``buckets``.
        """
        bucket_list = [(int(n_c), int(k_c)) for n_c, k_c in buckets]
        # mirror preprocess: bucketing only deduplicates across >1 partition
        bucket = self.bucket_classes and len(bucket_list) > 1
        easy = self._set_fn(self.easy_fn)
        hard = self._set_fn(self.hard_fn)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        rng = np.random.default_rng(0)
        rf = max(1, int(self.refine_factor))
        seen: set[tuple[int, int]] = set()
        for n_c, k_c in bucket_list:
            k_sel = min(n_c, rf * k_c)
            if k_sel <= 0 or (n_c, k_sel) in seen:
                continue
            seen.add((n_c, k_sel))
            dummy = rng.normal(size=(n_c, d)).astype(np.float32)
            _, imp = self._class_selection(dummy, k_sel, bucket=bucket, easy=easy,
                                           hard=hard, generator=gen)
            taylor_softmax(torch.from_numpy(imp))
        if rf > 1:
            n_union = sum(min(n_c, rf * k_c) for n_c, k_c in bucket_list if k_c > 0)
            k_total = sum(k_c for _, k_c in bucket_list if k_c > 0)
            if 0 < k_total < n_union:
                dummy = rng.normal(size=(n_union, d)).astype(np.float32)
                self._refine_indices(dummy, k_total, easy)
        return len(seen)

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
        i-th partition (in the strategy's partition order; classes in
        ascending label order): an (n_sge_subsets, k_run, n_run) array in
        the run's (bucketed) geometry, where k_run is the bucket of the
        oversampled bank width ``min(n_c, refine_factor·k_c)``.  Under a
        quarantine the partitions are those of the surviving rows.

        With ``firewall`` set, the ground set is screened first
        (``health.validate_features``, on the host) and the report is
        stamped into the artifact's config under ``data_health``.  Under
        ``quarantine`` the flagged rows are left out of selection: ``k`` is
        computed over the surviving rows, the artifact is mapped back to the
        full ground set (quarantined rows get zero WRE probability and are
        in no SGE subset), and their indices are recorded in full.
        """
        features = np.asarray(features)
        report = None
        if self.firewall is not None:
            from repro_torch.health.firewall import validate_features

            features, report = validate_features(
                features, labels, policy=self.firewall,
                subset_fraction=self.subset_fraction,
                # overbudget detection mirrors the decomposition selection
                # will use (classwise off: the single catch-all)
                strategy=self.partition_strategy() if self.classwise else None,
            )
        quarantined = report.quarantined_rows if report is not None else []
        kw = dict(encoder_id=encoder_id, prep_seed=prep_seed, sge_noise=sge_noise)
        if quarantined:
            m = features.shape[0]
            labels_full = None if labels is None else np.asarray(labels, np.int64)
            keep = np.setdiff1d(np.arange(m, dtype=np.int64),
                                np.asarray(quarantined, np.int64))
            md = self._preprocess_clean(
                features[keep], None if labels_full is None else labels_full[keep], seed, **kw)
            md = self._lift_quarantined(md, keep, m, labels_full)
        else:
            md = self._preprocess_clean(features, labels, seed, **kw)
        if report is not None:
            md.config["firewall"] = self.firewall
            md.config["data_health"] = report.to_dict()
        return md

    @staticmethod
    def _lift_quarantined(md: MiloMetadata, keep: np.ndarray, m: int,
                          labels_full: np.ndarray | None) -> MiloMetadata:
        """Re-index an artifact built over ``features[keep]`` to the full
        ground set: bank indices map through ``keep``, probabilities and
        importance scatter into zeros at the quarantined rows."""
        probs = np.zeros((m,), np.float32)
        probs[keep] = md.wre_probs
        imp = np.zeros((m,), np.float32)
        imp[keep] = md.wre_importance
        return MiloMetadata(
            sge_subsets=keep[md.sge_subsets],
            wre_probs=probs,
            wre_importance=imp,
            class_labels=(labels_full if labels_full is not None
                          else np.zeros((m,), np.int64)),
            class_budgets=md.class_budgets,
            config=md.config,
        )

    def _preprocess_clean(
        self,
        features: np.ndarray,
        labels: np.ndarray | None,
        seed: int,
        *,
        encoder_id: str,
        prep_seed: int | None,
        sge_noise: Sequence[Any] | None,
    ) -> MiloMetadata:
        if self.gram_free and self.metric != "cosine":
            raise ValueError(
                f"gram_free preprocessing supports metric='cosine' only (got "
                f"{self.metric!r}); the gram-free set functions rebuild "
                "rescaled-cosine columns from features on the fly")
        m = features.shape[0]
        k = max(1, int(round(self.subset_fraction * m)))
        labels_arr = (np.zeros((m,), np.int64) if labels is None
                      else np.asarray(labels, np.int64))
        strategy = self.partition_strategy()
        # label-free strategies ignore the labels; by_class without labels
        # (or classwise off) gives the single catch-all partition
        parts = strategy.partition(
            None if labels is None or not self.classwise else labels_arr, m)
        budgets = proportional_budgets(parts, k)
        rf = max(1, int(self.refine_factor))
        # oversampled per-partition bank widths (== budgets when rf == 1)
        sel_widths = [min(len(p.indices), rf * b) for p, b in zip(parts, budgets)]
        easy = self._set_fn(self.easy_fn)
        hard = self._set_fn(self.hard_fn)
        # bucketing only deduplicates across >1 partition (as the reference)
        bucket = self.bucket_classes and len(parts) > 1
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        per_class_sge: list[np.ndarray] = []
        wre_probs = np.zeros((m,), np.float32)
        wre_importance = np.zeros((m,), np.float32)
        for i, (part, k_sel) in enumerate(zip(parts, sel_widths)):
            n_c = len(part.indices)
            if k_sel <= 0:
                per_class_sge.append(np.zeros((self.n_sge_subsets, 0), np.int64))
                imp = np.zeros((n_c,), np.float32)
            else:
                subs_c, imp = self._class_selection(
                    features[part.indices], k_sel, bucket=bucket, easy=easy, hard=hard,
                    generator=gen, noise=None if sge_noise is None else sge_noise[i],
                )
                per_class_sge.append(subs_c)
            wre_importance[part.indices] = imp
            # within-class Taylor-softmax, weighted by class mass so the
            # global vector is a distribution with stratified expectation
            p_local = taylor_softmax(torch.from_numpy(imp)).numpy()
            wre_probs[part.indices] = p_local * (n_c / m)

        wre_probs = _normalize_probs(wre_probs)
        if rf > 1:
            # level 1: each slot's oversampled union refined down to k
            sge_subsets = self._refine_bank(features, parts, per_class_sge, k, easy)
        else:
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
        # partition provenance only off the flat path: flat configs (and
        # their config_hash) stay key for key the pre-hierarchy ones
        if strategy.name != "by_class" or rf > 1:
            config.update(strategy.config())
            config["refine_factor"] = rf
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


def _hier_kernel(
    feats: np.ndarray,
    n_pad: int,
    *,
    gram_free: bool,
    metric: str,
    gram_block: int,
    use_pallas: bool,
    device: torch.device,
    pre_normalized: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(engine kernel, valid mask) for one partition, padded to ``n_pad``:
    zero feature rows (gram-free) or zero Gram rows and columns past the
    partition's rows, as the reference pads every partition to one shape.
    The masking is exact, so the first n-valid picks equal the unpadded
    run's."""
    z = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    n = z.shape[0]
    if gram_free:
        A = torch.zeros((n_pad, z.shape[1]), dtype=torch.float32, device=device)
        A[:n] = z if pre_normalized else normalize_rows(z)
    else:
        A = gram_matrix_blocked(z, metric=metric, block=gram_block, use_pallas=use_pallas,
                                n_pad=n_pad)
    return A, torch.arange(n_pad, device=device) < n


def _two_level_select(
    features: np.ndarray,
    k: int,
    parts: Sequence[Partition],
    budgets: Sequence[int],
    rf: int,
    fn: submodular.SetFunction,
    *,
    gram_free: bool,
    metric: str = "cosine",
    gram_block: int = 2048,
    use_pallas: bool = False,
    lazy_threshold: float | None = 0.125,
    pre_normalized: bool = False,
    device: torch.device,
) -> tuple[np.ndarray, dict]:
    """Shared partition-then-refine selection (deterministic greedy, both levels).

    Level 0: exact greedy inside every partition, each padded to the largest
    partition's ``n_max`` rows and run for the largest width ``k_max``, of
    whose picks the first ``min(n_c, rf·k_c)`` are kept (the reference's
    geometry, so the trajectories are its); level 1: ``greedy.refine`` over
    the union of winners down to exactly ``k``.  Peak device memory is
    O(n_max·d) gram-free (O(n_max²) with a Gram): the partition size, not
    the ground set's.
    """
    kern = dict(gram_free=gram_free, metric=metric, gram_block=gram_block,
                use_pallas=use_pallas, device=device, pre_normalized=pre_normalized)
    active = [(p, b) for p, b in zip(parts, budgets) if b > 0 and len(p.indices) > 0]
    if not active:
        return np.zeros((0,), np.int64), {
            "n_partitions": len(parts), "union_size": 0,
            "peak_partition_rows": 0, "refine_factor": rf,
        }
    k_sels = [min(len(p.indices), rf * b) for p, b in active]
    n_max = max(len(p.indices) for p, _ in active)
    k_max = max(k_sels)
    winners = []
    for (p, _), k_sel in zip(active, k_sels):
        A, valid = _hier_kernel(features[p.indices], n_max, **kern)
        res = greedy(fn, A, k_max, valid=valid, n=n_max)
        # the first k_sel picks of the padded run are the unpadded run's
        local = res.indices[:k_sel].cpu().numpy().astype(np.int64)
        winners.append(np.asarray(p.indices, np.int64)[local])
    union = np.concatenate(winners)
    if len(union) > k:
        n_u = len(union)
        A, valid = _hier_kernel(features[union], n_u, **kern)
        lazy_budget = None
        if lazy_threshold is not None and fn.lazy is not None:
            b = max(1, int(n_u * lazy_threshold))
            lazy_budget = b if b < n_u else None
        res = run_refine(fn, A, k, valid=valid, lazy_budget=lazy_budget)
        selected = union[res.indices.cpu().numpy().astype(np.int64)]
    else:
        selected = union
    info = {
        "n_partitions": len(parts),
        "union_size": int(len(union)),
        "peak_partition_rows": int(n_max),
        "refine_factor": rf,
    }
    return selected, info


def _empty_select(refine_factor: int, return_info: bool):
    empty = np.zeros((0,), np.int64)
    info = {"n_partitions": 0, "union_size": 0, "peak_partition_rows": 0,
            "refine_factor": refine_factor}
    return (empty, info) if return_info else empty


def hierarchical_select(
    features: np.ndarray,
    k: int,
    *,
    labels: np.ndarray | None = None,
    partition: str | PartitionStrategy = "random_blocks",
    block_size: int = 4096,
    seed: int = 0,
    refine_factor: int = 2,
    fn_name: str = "facility_location",
    gram_free: bool = True,
    metric: str = "cosine",
    gram_block: int = 2048,
    use_pallas: bool = False,
    graph_cut_lambda: float = 0.4,
    lazy_threshold: float | None = 0.125,
    return_info: bool = False,
    device: str | torch.device = "cuda",
):
    """One-shot hierarchical subset selection (partition → greedy → refine).

    A :class:`PartitionStrategy` splits the ground set, exact greedy picks
    ``refine_factor·k_c`` winners inside each partition, and a level-1
    ``greedy.refine`` over the union returns exactly ``k`` global indices.
    With ``use_pallas=True`` the gram-free facility-location gains run
    through the ``fl_gains`` kernels (the lazy refine's corrections too) and
    a dense Gram through the similarity kernel; ``False`` is the plain route.

    Returns the (k,) int64 global indices; with ``return_info=True`` also a
    dict of the run's geometry (partition count, union size, peak partition
    rows, refine factor).
    """
    features = np.asarray(features)
    m = features.shape[0]
    k = max(0, min(int(k), m))
    if k == 0:
        return _empty_select(refine_factor, return_info)
    strategy = (partition if isinstance(partition, PartitionStrategy)
                else make_partition_strategy(partition, block_size=block_size, seed=seed))
    parts = strategy.partition(labels, m)
    budgets = proportional_budgets(parts, k)
    rf = max(1, int(refine_factor))
    pre = MiloPreprocessor(easy_fn=fn_name, gram_free=gram_free, metric=metric,
                           gram_block=gram_block, use_pallas=use_pallas,
                           graph_cut_lambda=graph_cut_lambda, device=device)
    selected, info = _two_level_select(
        features, k, parts, budgets, rf, pre._set_fn(fn_name), gram_free=gram_free,
        metric=metric, gram_block=gram_block, use_pallas=use_pallas,
        lazy_threshold=lazy_threshold, device=pre.device,
    )
    return (selected, info) if return_info else selected


def targeted_select(
    features: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    labels: np.ndarray | None = None,
    partition: str | PartitionStrategy = "by_class",
    block_size: int = 4096,
    seed: int = 0,
    refine_factor: int = 4,
    return_info: bool = False,
    device: str | torch.device = "cuda",
):
    """Query-conditioned (SMI-style) targeted selection over partition winners.

    ``queries`` holds a few exemplar embeddings of the slice of interest;
    both levels maximise query facility location, f(S) = Σ_q max_{a∈S}
    sim(a, q), so the subset covers the queries rather than the ground set.
    Gram-free cosine only, plain PyTorch (``gram_free.make_query_facility_location``
    reaches no kernel).  Returns the (k,) int64 global indices (and the
    geometry dict with ``return_info=True``).
    """
    dev = resolve_device(device)
    features = np.asarray(features)
    m = features.shape[0]
    k = max(0, min(int(k), m))
    if k == 0:
        return _empty_select(refine_factor, return_info)

    def normalized(a) -> np.ndarray:
        t = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return normalize_rows(t).cpu().numpy()

    zn = normalized(features)
    fn = gram_free_mod.make_query_facility_location(normalized(queries))
    strategy = (partition if isinstance(partition, PartitionStrategy)
                else make_partition_strategy(partition, block_size=block_size, seed=seed))
    parts = strategy.partition(labels, m)
    budgets = proportional_budgets(parts, k)
    rf = max(1, int(refine_factor))
    selected, info = _two_level_select(
        zn, k, parts, budgets, rf, fn, gram_free=True, pre_normalized=True,
        lazy_threshold=None, device=dev,
    )
    return (selected, info) if return_info else selected


def preprocess_with_encoder(
    encode_fn: Callable[[Any], Any],
    inputs: Any,
    labels: np.ndarray | None,
    seed: int = 0,
    *,
    batch_size: int = 256,
    encoder_id: str = "custom",
    sge_noise: Sequence[Any] | None = None,
    **pre_kwargs,
) -> MiloMetadata:
    """Encode ``inputs`` in batches of ``batch_size`` with a frozen encoder,
    then preprocess the features with ``MiloPreprocessor(**pre_kwargs)``
    (``device=`` among them).  ``encode_fn`` may return a tensor or an
    array; ``seed`` and ``sge_noise`` are ``preprocess``'s."""
    feats = []
    for lo in range(0, len(inputs), batch_size):
        out = encode_fn(inputs[lo:lo + batch_size])
        feats.append(out.detach().cpu().numpy() if isinstance(out, torch.Tensor)
                     else np.asarray(out))
    features = np.concatenate(feats, axis=0)
    pre = MiloPreprocessor(**pre_kwargs)
    return pre.preprocess(features, labels, seed, encoder_id=encoder_id, sge_noise=sge_noise)
