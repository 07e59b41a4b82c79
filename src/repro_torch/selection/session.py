"""``MiloSession`` — the one-call facade for the paper's workflow, on PyTorch.

Port of ``repro.selection.session``::

    session = MiloSession(MiloSessionConfig(subset_fraction=0.1, total_epochs=40,
                                            use_pallas=True), device="cuda")
    session.preprocess(features, labels)        # once per (dataset, k)
    r1 = session.train(features, labels, test_x=tx, test_y=ty)
    best = session.tune(features, labels, vx, vy, {"lr": ("log", 1e-3, 0.3)})

``preprocess`` runs the model-agnostic stage (or reloads a saved artifact
whose config matches; ``adopt_metadata`` installs one built elsewhere);
``train`` wires a registry-built selector into ``Pipeline`` + ``Trainer``
with plan weights flowing into the loss, on the step loop or, with
``fused_training=True``, on the fused engine (CUDA graphs on the card);
``tune`` runs Hyperband over ``lr``/``hidden`` with a fresh selector for
every trial.  The config is the reference's, field for field, so its keys
and every artifact's ``config_hash`` are the same; ``device`` is a
constructor keyword argument, not a field.

``firewall`` screens the ground set before preprocessing
(``health.firewall``); ``selector_fallback`` wraps the selector in a
``health.FallbackSelector`` chain.  A ``buffer_registry``
(``serve.BufferRegistry``) gives the fused path its resident columns, so
every session of a ``serve.MiloServer`` trains on one device copy of a
dataset and the fused engine's graphs survive from tenant to tenant.  One
session may serve several threads at once (the server's workers): its
step functions are made under a lock, and the fused engine serialises
what its graphs share (``train.engine``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.metadata import MetadataMismatchError, MiloMetadata, is_preprocessed
from repro_torch.core.milo import MiloPreprocessor
from repro_torch.data.pipeline import Pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import multihost
from repro_torch.models.classifier import accuracy, init_mlp, nesterov_update, weighted_nll
from repro_torch.selection.base import Selector
from repro_torch.selection.registry import build_selector, selector_entry
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tuning.tuner import (
    HyperbandResult, RandomSearch, TPESearch, hyperband, subset_objective,
)


def _data_fingerprint(features: np.ndarray) -> str:
    """Cheap content identity for a feature matrix."""
    a = np.ascontiguousarray(np.asarray(features, np.float32))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


#: config keys that must match when reusing a saved preprocessing artifact
_PREPROCESS_KEYS = (
    "subset_fraction", "n_sge_subsets", "eps", "easy_fn", "hard_fn",
    "graph_cut_lambda", "classwise", "metric",
)

@dataclasses.dataclass
class MiloSessionConfig:
    """Everything the session needs, in one object (the reference's fields,
    names and defaults; see ``repro.selection.session.MiloSessionConfig``)."""

    selector: str = "milo"
    subset_fraction: float = 0.1
    n_sge_subsets: int = 8
    eps: float = 0.01
    easy_fn: str = "graph_cut"
    hard_fn: str = "disparity_min"
    graph_cut_lambda: float = 0.4
    classwise: bool = True
    metric: str = "cosine"
    gram_block: int = 2048
    use_pallas: bool = False
    gram_free: bool = False
    bucket_classes: bool = True
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
    selector_fallback: tuple[str, ...] = ()
    total_epochs: int = 40
    kappa: float = 1.0 / 6.0
    R: int = 1
    seed: int = 0
    prep_seed: int | None = None
    fused_training: bool = False
    superstep: int = 32
    lr: float = 0.05
    hidden: int = 64
    n_classes: int | None = None
    sub_steps: int = 4
    batch_size: int = 0          # 0 = one full-subset batch per epoch
    eval_every_epochs: int = 1
    metadata_path: str | None = None
    # multi-host execution (distributed.multihost): start torch.distributed
    # at construction from the MILO_COORDINATOR / MILO_NUM_PROCESSES /
    # MILO_PROCESS_ID env triplet (idempotent; a no-op without it).  Then
    # shard_selection's mesh spans every rank with no further knobs
    multihost_init: bool = False
    # host-liveness beacons for train(): every step boundary writes this
    # host's heartbeat and checks its peers'; a peer stale past the timeout
    # raises HostLossError.  The directory must be shared by the job's hosts
    heartbeat_dir: str | None = None
    heartbeat_timeout: float = 60.0

    def preprocessor(self, device: str | torch.device = "cuda") -> MiloPreprocessor:
        return MiloPreprocessor(
            subset_fraction=self.subset_fraction,
            n_sge_subsets=self.n_sge_subsets,
            eps=self.eps,
            easy_fn=self.easy_fn,
            hard_fn=self.hard_fn,
            graph_cut_lambda=self.graph_cut_lambda,
            classwise=self.classwise,
            metric=self.metric,
            gram_block=self.gram_block,
            use_pallas=self.use_pallas,
            gram_free=self.gram_free,
            bucket_classes=self.bucket_classes,
            sge_vmapped=self.sge_vmapped,
            shard_selection=self.shard_selection,
            lazy_gains=self.lazy_gains,
            lazy_threshold=self.lazy_threshold,
            lazy_two_level=self.lazy_two_level,
            exact_sge_candidates=self.exact_sge_candidates,
            firewall=self.firewall,
            partition=self.partition,
            partition_block=self.partition_block,
            partition_seed=self.partition_seed,
            refine_factor=self.refine_factor,
            device=device,
        )

    def resolved_prep_seed(self) -> int:
        return self.seed if self.prep_seed is None else self.prep_seed

    def expected_artifact_config(self) -> dict[str, Any]:
        """The stored-config keys a reusable artifact must agree on."""
        return {k: getattr(self, k) for k in _PREPROCESS_KEYS}


@dataclasses.dataclass
class TrainReport:
    final_acc: float
    best_acc: float
    train_time: float
    steps: int
    history: list[dict]


class _ClassifierState(NamedTuple):
    params: dict
    mom: dict
    step: torch.Tensor          # () int64, advanced in place by each step
    lr0: torch.Tensor           # () f32 — device tensors, as the reference
    total_steps: torch.Tensor   # () f32   keeps them traced


def _init_classifier(seed: int, d_in: int, n_classes: int, hidden: int, lr0: float,
                     total_steps: int, device: torch.device) -> _ClassifierState:
    params = init_mlp(torch.Generator().manual_seed(seed), d_in, n_classes, hidden,
                      device=device)
    return _ClassifierState(
        params, {k: torch.zeros_like(v) for k, v in params.items()},
        torch.zeros((), dtype=torch.int64, device=device),
        torch.tensor(lr0, dtype=torch.float32, device=device),
        torch.tensor(total_steps, dtype=torch.float32, device=device))


def _classifier_step_fn(sub_steps: int):
    """Weighted-CE Nesterov-SGD step with cosine decay; consumes the plan
    weights the pipeline injects into ``batch["weights"]``.  The reference's
    ``lax.scan`` over sub-steps is a loop here, with autograd per sub-step.
    Everything runs on the device — the cosine lr from the state's tensors,
    ``step += 1`` in place — so the step loop and a graph replay run the same
    ops and no host value is baked into a captured graph.  Each call makes a
    new function: ``MiloSession`` keeps one per ``sub_steps`` value."""

    def train_step(state: _ClassifierState, batch: dict):
        x, y = batch["x"], batch["y"]
        w = batch.get("weights")
        if w is None:
            w = torch.ones(x.shape[:1], dtype=torch.float32, device=x.device)
        frac = state.step.to(torch.float32) / torch.clamp(state.total_steps - 1.0, min=1.0)
        lr = state.lr0 * 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(frac, max=1.0)))
        params, mom = state.params, state.mom
        for p in params.values():
            p.requires_grad_(True)
        for _ in range(sub_steps):
            loss = weighted_nll(params, x, y, w)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            nesterov_update(params, mom, grads, lr)
        state.step.add_(1)
        return state, {"loss": loss.detach()}

    train_step.updates_in_place = True   # the guard keeps the pre-step state
    return train_step


class MiloSession:
    """Facade over preprocess → (many) train, on ``device``."""

    def __init__(
        self,
        config: MiloSessionConfig | None = None,
        *,
        device: str | torch.device = "cuda",
        buffer_registry: Any | None = None,
        **overrides: Any,
    ):
        if config is None:
            config = MiloSessionConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.device = resolve_device(device)
        if config.multihost_init:
            multihost.initialize(device=self.device)
        self.config = config
        self.metadata: MiloMetadata | None = None
        self.loaded_from_artifact = False
        # shared device columns for the fused path (serve.BufferRegistry)
        self.buffer_registry = buffer_registry
        # without a registry: the (features, labels, device columns) a tune()
        # sweep shares across its trials, so the fused engine's graphs (which
        # read the columns in place) are captured once per shape, not once
        # per trial
        self._columns: tuple[Any, Any, dict] | None = None
        self._lock = threading.Lock()
        # one step function per sub_steps value, shared by every train() and
        # tune() of this session: lr and horizon live in the state's tensors,
        # so the fused engine (weakly keyed by step function) reuses its
        # graphs across a Hyperband lr sweep, and the engine, its graphs,
        # their static state and the resident buffers die with the session
        self._steps: dict[int, Any] = {}

    # -- stage 1: model-agnostic preprocessing ------------------------------

    def preprocess(
        self,
        features: np.ndarray,
        labels: np.ndarray | None = None,
        *,
        force: bool = False,
        encoder_id: str = "precomputed",
        sge_noise: Any = None,
    ) -> MiloMetadata:
        """Run (or load) the one-shot preprocessing pass.

        A ``metadata_path`` naming an artifact whose config matches is loaded
        instead of recomputed (``force=True`` recomputes).  ``sge_noise`` is
        the draw seam of ``MiloPreprocessor.preprocess``.
        """
        cfg = self.config
        if not force and cfg.metadata_path and is_preprocessed(cfg.metadata_path):
            md = self._load_artifact(encoder_id, _data_fingerprint(features))
            if md.m != len(features):
                raise MetadataMismatchError(
                    f"{cfg.metadata_path}: artifact was preprocessed over "
                    f"{md.m} samples but this dataset has {len(features)} — "
                    "same config, different data; pass force=True to rebuild"
                )
            self.metadata = md
            self.loaded_from_artifact = True
            return md
        md = self.build_metadata(features, labels, encoder_id=encoder_id, sge_noise=sge_noise)
        if cfg.metadata_path:
            md.save(cfg.metadata_path)
        self.metadata = md
        self.loaded_from_artifact = False
        return md

    def build_metadata(
        self,
        features: np.ndarray,
        labels: np.ndarray | None = None,
        *,
        encoder_id: str = "precomputed",
        fingerprint: str | None = None,
        sge_noise: Any = None,
    ) -> MiloMetadata:
        """The compute unit behind ``preprocess``: the stamped artifact,
        without touching session state or ``metadata_path``."""
        cfg = self.config
        seed = cfg.resolved_prep_seed()
        md = cfg.preprocessor(self.device).preprocess(
            features, labels, seed, encoder_id=encoder_id, prep_seed=seed,
            sge_noise=sge_noise,
        )
        md.config["data_fingerprint"] = (
            fingerprint if fingerprint is not None else _data_fingerprint(features))
        return md

    def _load_artifact(self, encoder_id: str | None = None,
                       data_fingerprint: str | None = None) -> MiloMetadata:
        """Load + verify the configured artifact (the reference's checks)."""
        cfg = self.config
        path = cfg.metadata_path
        md = MiloMetadata.load(path, expected_config=cfg.expected_artifact_config())
        mismatch = {}
        stored_enc = md.config.get("encoder_id")
        if encoder_id is not None and stored_enc is not None and stored_enc != encoder_id:
            mismatch["encoder_id"] = (stored_enc, encoder_id)
        stored_fp = md.config.get("data_fingerprint")
        if data_fingerprint is not None and stored_fp is not None and stored_fp != data_fingerprint:
            raise MetadataMismatchError(
                f"{path}: artifact was preprocessed over different data "
                "(feature fingerprint mismatch); pass force=True to rebuild")
        # knobs that change which trajectories the artifact holds
        for knob in ("gram_free", "bucket_classes", "lazy_gains", "exact_sge_candidates"):
            stored = md.config.get(knob)
            if stored is not None and bool(stored) != getattr(cfg, knob):
                mismatch[knob] = (stored, getattr(cfg, knob))
        stored_seed = md.config.get("prep_seed")
        if stored_seed is not None and stored_seed != cfg.resolved_prep_seed():
            mismatch["prep_seed"] = (stored_seed, cfg.resolved_prep_seed())
        if "firewall" in md.config and md.config["firewall"] != cfg.firewall:
            mismatch["firewall"] = (md.config["firewall"], cfg.firewall)
        mismatch.update(self._partition_mismatch(md))
        if mismatch:
            raise MetadataMismatchError(
                f"{path}: config mismatch on {mismatch} (stored, expected)")
        return md

    def _partition_mismatch(self, md: MiloMetadata) -> dict[str, tuple]:
        """Partition provenance shared by artifact load and adopt (the
        reference's ``_check_partition_config``).  Partition keys are stamped
        only off the flat path, so their absence means the flat by-class
        path: a hierarchical session refuses a flat artifact, and any
        partition or refine disagreement refuses; block and seed are stamped
        only by the strategies that use them."""
        cfg = self.config
        bad: dict[str, tuple] = {}
        stored_part = md.config.get("partition", "by_class")
        if stored_part != cfg.partition:
            bad["partition"] = (stored_part, cfg.partition)
        stored_rf = int(md.config.get("refine_factor", 1))
        want_rf = max(1, int(cfg.refine_factor))
        if stored_rf != want_rf:
            bad["refine_factor"] = (stored_rf, want_rf)
        for key, want in (("partition_block", cfg.partition_block),
                          ("partition_seed", cfg.partition_seed)):
            if key in md.config and int(md.config[key]) != int(want):
                bad[key] = (md.config[key], want)
        return bad

    def adopt_metadata(self, md: MiloMetadata, *, loaded: bool = True) -> MiloMetadata:
        """Install an externally owned artifact (one another session or
        process built or reloaded) as this session's preprocessing result,
        after the config checks a ``metadata_path`` load applies."""
        expected = self.config.expected_artifact_config()
        bad = {k: (md.config.get(k), v) for k, v in expected.items()
               if k in md.config and md.config.get(k) != v}
        if bad:
            raise MetadataMismatchError(
                f"adopted artifact: config mismatch on {bad} (stored, expected)")
        stored_seed = md.config.get("prep_seed")
        expected_seed = self.config.resolved_prep_seed()
        if stored_seed is not None and stored_seed != expected_seed:
            raise MetadataMismatchError(
                "adopted artifact: config mismatch on "
                f"{{'prep_seed': ({stored_seed}, {expected_seed})}} (stored, expected)")
        bad = self._partition_mismatch(md)
        if bad:
            raise MetadataMismatchError(
                f"adopted artifact: config mismatch on {bad} (stored, expected)")
        self.metadata = md
        self.loaded_from_artifact = loaded
        return md

    def _require_metadata(self, n: int | None = None,
                          features: np.ndarray | None = None) -> MiloMetadata:
        if self.metadata is None:
            if self.config.metadata_path and is_preprocessed(self.config.metadata_path):
                self.metadata = self._load_artifact(
                    data_fingerprint=(_data_fingerprint(features)
                                      if features is not None else None))
                self.loaded_from_artifact = True
            else:
                raise MetadataMismatchError(
                    "no preprocessing artifact: call session.preprocess(...) first")
        if n is not None and self.metadata.m != n:
            raise MetadataMismatchError(
                f"preprocessing artifact covers {self.metadata.m} samples but "
                f"this dataset has {n} — same config, different data")
        return self.metadata

    # -- registry wiring ----------------------------------------------------

    def selector(
        self,
        name: str | None = None,
        *,
        n: int,
        epochs: int | None = None,
        seed: int | None = None,
        features: np.ndarray | None = None,
        **extra: Any,
    ) -> Selector:
        """Build this session's selector from the registry.  ``milo``,
        ``milo_fixed``, ``full``, ``random`` and ``adaptive_random`` are wired
        from session state; the other strategies (``milo_hier``,
        ``milo_targeted`` and the paper's baselines) get the session's k,
        n, seed, features and device for the fields their configs declare,
        and take the rest (labels, queries, scores, ``grad_fn``, ``R``, ...)
        through ``extra``.  Selection runs on the session's device, and
        ``milo`` takes ``wre_noise=`` through ``extra``.

        With ``config.selector_fallback`` declared, the result is a
        ``health.FallbackSelector`` walking ``(primary, *fallbacks)``:
        degenerate selection math degrades down the chain, every hop in the
        plan's provenance.  The fallback tiers are wired from session state
        only (``extra`` applies to the primary)."""
        cfg = self.config
        resolved = name or cfg.selector
        if not cfg.selector_fallback:
            return self._build_selector(resolved, n=n, epochs=epochs, seed=seed,
                                        features=features, **extra)
        from repro_torch.health.fallback import FallbackSelector

        def factory(nm: str, ex: dict):
            return lambda: self._build_selector(nm, n=n, epochs=epochs, seed=seed,
                                                features=features, **ex)

        chain = [(resolved, factory(resolved, dict(extra)))]
        chain += [(fb, factory(fb, {})) for fb in cfg.selector_fallback]
        return FallbackSelector(chain)

    def _build_selector(
        self,
        name: str | None = None,
        *,
        n: int,
        epochs: int | None = None,
        seed: int | None = None,
        features: np.ndarray | None = None,
        **extra: Any,
    ) -> Selector:
        cfg = self.config
        name = name or cfg.selector
        selector_entry(name)  # KeyError for unknown names
        epochs = epochs if epochs is not None else cfg.total_epochs
        seed = seed if seed is not None else cfg.seed
        explicit_k = "k" in extra
        k = extra.pop("k", None)
        if k is None:
            k = (self.metadata.k if self.metadata is not None
                 else max(1, int(round(cfg.subset_fraction * n))))
        if name == "milo":
            md = self._require_metadata(n, features)
            if explicit_k and k != md.k:
                raise ValueError(
                    f"milo's subset size is fixed by the preprocessing "
                    f"artifact (k={md.k}); rebuild the artifact to change it")
            return build_selector("milo", metadata=md, total_epochs=epochs,
                                  kappa=cfg.kappa, R=cfg.R, seed=seed,
                                  device=self.device, **extra)
        if name == "milo_fixed":
            if features is None:
                raise ValueError("milo_fixed needs `features`")
            return build_selector("milo_fixed", features=features, k=k,
                                  device=self.device, **extra)
        if name == "full":
            if explicit_k:
                raise ValueError("selector 'full' trains on the whole dataset; "
                                 "`k` is not applicable")
            return build_selector("full", n=n, **extra)
        if name == "random":
            return build_selector("random", n=n, k=k, seed=seed, **extra)
        if name == "adaptive_random":
            return build_selector("adaptive_random", n=n, k=k,
                                  R=extra.pop("R", cfg.R), seed=seed, **extra)
        # other strategies: forward the session context for every field
        # their config declares
        fields = {f.name for f in dataclasses.fields(selector_entry(name).config_cls)}
        kwargs = dict(extra)
        for key, val in (("k", k), ("n", n), ("seed", seed), ("features", features),
                         ("device", self.device)):
            if key in fields and val is not None:
                kwargs.setdefault(key, val)
        return build_selector(name, **kwargs)

    def pipeline(
        self,
        make_batch,
        selector: Selector,
        batch_size: int,
        *,
        seed: int | None = None,
        prefetch: bool = True,
        arrays: dict | None = None,
        resident: dict | None = None,
    ) -> Pipeline:
        """A ``Pipeline`` on the session's device and seed; with a buffer
        registry and a column store, its shared device columns."""
        if resident is None and arrays is not None and self.buffer_registry is not None:
            resident = self.buffer_registry.get(arrays)
        return Pipeline(
            make_batch, selector, batch_size,
            seed=self.config.seed if seed is None else seed,
            prefetch=prefetch, arrays=arrays, resident=resident, device=self.device,
        )

    # -- stage 2: train any number of downstream models ---------------------

    def train(
        self,
        features: np.ndarray,
        labels: np.ndarray,
        *,
        test_x: np.ndarray,
        test_y: np.ndarray,
        selector: str | Selector | None = None,
        epochs: int | None = None,
        seed: int | None = None,
        lr: float | None = None,
        hidden: int | None = None,
        **selector_kwargs: Any,
    ) -> TrainReport:
        """Train one downstream classifier on registry-selected subsets."""
        cfg = self.config
        dev = self.device
        epochs = epochs if epochs is not None else cfg.total_epochs
        seed = seed if seed is not None else cfg.seed
        lr = lr if lr is not None else cfg.lr
        hidden = hidden if hidden is not None else cfg.hidden
        n = len(features)
        if isinstance(selector, Selector) or hasattr(selector, "plan"):
            if selector_kwargs:
                raise ValueError(
                    "selector is already a built instance; selector kwargs "
                    f"{sorted(selector_kwargs)} would be silently ignored")
            sel = selector
        else:
            sel = self.selector(selector, n=n, epochs=epochs, seed=seed,
                                features=features, **selector_kwargs)

        feats = np.asarray(features, np.float32)
        labs = np.asarray(labels, np.int64)
        # size the head over every label the run will see
        max_label = int(max(labs.max(), np.asarray(test_y).max()))
        if cfg.n_classes is None:
            n_classes = max_label + 1
        elif cfg.n_classes <= max_label:
            raise ValueError(
                f"n_classes={cfg.n_classes} cannot cover label {max_label} "
                "present in the train/eval data")
        else:
            n_classes = cfg.n_classes

        def make_batch(idx: np.ndarray) -> dict:
            return {"x": feats[idx], "y": labs[idx]}

        plan0 = sel.plan(0).validate(n)
        batch_size = cfg.batch_size or plan0.k
        if batch_size > plan0.k:
            raise ValueError(
                f"batch_size={batch_size} exceeds the selected subset size "
                f"k={plan0.k}; every epoch would yield zero batches")
        # the column store mirrors make_batch exactly, enabling the fused
        # device-resident path when cfg.fused_training asks for it
        pipe = Pipeline(make_batch, sel, batch_size, seed=seed,
                        arrays={"x": feats, "y": labs}, device=dev)
        steps = max(1, pipe.steps_per_epoch()) * epochs
        with self._lock:
            train_step = self._steps.get(cfg.sub_steps)
            if train_step is None:
                train_step = self._steps[cfg.sub_steps] = _classifier_step_fn(cfg.sub_steps)

        def init_state() -> _ClassifierState:
            return _init_classifier(seed, feats.shape[1], n_classes, hidden, float(lr),
                                    steps, dev)

        tx = torch.as_tensor(np.asarray(test_x, np.float32), device=dev)
        ty = torch.as_tensor(np.asarray(test_y, np.int64), device=dev)

        def eval_fn(st: _ClassifierState) -> dict:
            return {"acc": accuracy(st.params, tx, ty)}

        trainer = Trainer(
            train_step, pipe,
            TrainerConfig(epochs=epochs, eval_every_epochs=cfg.eval_every_epochs,
                          log_every_steps=1, heartbeat_dir=cfg.heartbeat_dir,
                          heartbeat_timeout=cfg.heartbeat_timeout),
            eval_fn=eval_fn, fused=cfg.fused_training, superstep=cfg.superstep,
            resident_buffers=self._resident(features, labels, feats, labs),
        )
        # warm up outside the timed region (library handles, allocator, both
        # curriculum phases' draws) on a throwaway state, then drop the plan
        # caches so the timed run charges every epoch's selection
        if plan0.phase in ("sge", "wre"):
            sel.plan(max(epochs - 1, 0))
        train_step(init_state(), trainer.put_batch(next(iter(pipe.epoch(0)))))
        float(accuracy(init_state().params, tx, ty))
        # the fused path's segment graphs: captured (or found in the engine's
        # cache) on a throwaway state
        trainer.warm_fused(init_state())
        getattr(sel, "reset_cache", lambda: None)()
        pipe.invalidate_plan_cache()

        state = init_state()
        t0 = time.perf_counter()
        state = trainer.fit(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_time = time.perf_counter() - t0
        final = float(accuracy(state.params, tx, ty))
        accs = [float(h["acc"]) for h in trainer.history if "acc" in h] + [final]
        return TrainReport(final_acc=final, best_acc=max(accs), train_time=train_time,
                           steps=int(state.step), history=trainer.history)

    def _resident(self, features, labels, feats: np.ndarray, labs: np.ndarray) -> dict | None:
        """The fused path's resident columns: the registry's shared ones, or
        the ones a running tune() sweep shares, or None (the Trainer places
        its own)."""
        if not self.config.fused_training:
            return None
        if self.buffer_registry is not None:
            return self.buffer_registry.get({"x": feats, "y": labs})
        shared = self._columns
        if shared is not None and shared[0] is features and shared[1] is labels:
            return shared[2]
        return None

    # -- stage 3: hyper-parameter tuning ------------------------------------

    def tune(
        self,
        features: np.ndarray,
        labels: np.ndarray,
        val_x: np.ndarray,
        val_y: np.ndarray,
        space: dict,
        *,
        selector: str | None = None,
        search: str = "tpe",
        max_budget: int = 9,
        eta: int = 3,
        seed: int | None = None,
        batched_objective: Any | None = None,
        should_stop: Any | None = None,
        checkpoint: str | None = None,
        **selector_kwargs: Any,
    ) -> HyperbandResult:
        """Hyperband over ``space`` with registry-selected subsets powering
        every configuration evaluation (paper §4's 20-75x tuning speedups).

        Each trial trains ``max(2, budget)`` epochs on a freshly built
        selector and scores the validation accuracy.  ``batched_objective(
        configs, budget) -> scores`` evaluates a rung in one call;
        ``should_stop()`` is polled before every rung (an early stop returns
        ``stopped=True``); ``checkpoint`` names the JSON rung-state file that
        makes the sweep resumable with the identical trial stream and
        ``best_config`` (see ``tuning.hyperband``; the file is the
        reference's format, so either package resumes the other's)."""
        cfg = self.config
        seed = seed if seed is not None else cfg.seed
        tunable = {"lr", "hidden"}
        unknown = set(space) - tunable
        if unknown:
            raise ValueError(
                f"tune() searches over {sorted(tunable)}; unsupported space "
                f"keys {sorted(unknown)} would be sampled but never applied")
        searches = {"tpe": TPESearch, "random": RandomSearch}
        if search not in searches:
            raise ValueError(f"unknown search {search!r}; available: {sorted(searches)}")
        search_obj = searches[search](space, seed=seed)

        def train_fn(trial_cfg: dict, budget: int, sel) -> float:
            report = self.train(
                features, labels, test_x=val_x, test_y=val_y,
                selector=sel, epochs=max(2, budget), seed=seed,
                lr=trial_cfg.get("lr"), hidden=trial_cfg.get("hidden"),
            )
            return report.final_acc

        def selector_factory(budget: int):
            return self.selector(
                selector, n=len(features), epochs=max(2, budget), seed=seed,
                features=features, **selector_kwargs,
            )

        objective = subset_objective(train_fn, selector_factory)
        if cfg.fused_training and self.buffer_registry is None:
            self._columns = (features, labels, {
                "x": torch.as_tensor(np.asarray(features, np.float32), device=self.device),
                "y": torch.as_tensor(np.asarray(labels, np.int64), device=self.device)})
        try:
            return hyperband(objective, search_obj, max_budget=max_budget, eta=eta,
                             batched_objective=batched_objective,
                             should_stop=should_stop, checkpoint=checkpoint)
        finally:
            self._columns = None
