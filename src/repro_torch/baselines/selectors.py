"""Subset-selection baselines from the paper's experiments (§4), on PyTorch
(port of ``repro.baselines.selectors``).

The classes here are the *legacy* entry points exposing the
``indices_for_epoch`` protocol; ``repro_torch.selection``'s registry
(``build_selector("craig_pb", ...)``) wraps the same strategies in the
weighted ``SelectionPlan`` protocol.  The selection math lives in the
module-level functions (``craig_pb_select``, ``gradmatch_omp_select``,
``glister_select``) shared by both paths.

Model-independent strategies (selection cost off the critical path):

  RandomSelector          — fixed random subset (paper: RANDOM)
  AdaptiveRandomSelector  — fresh random subset every R epochs (ADAPTIVE-RANDOM)
  MiloFixedSelector       — fixed subset maximizing disparity-min (MILO (Fixed))
  EL2NSelector            — keep hardest/easiest by EL2N score [Paul et al.'21]
  SelfSupPruneSelector    — self-supervised prototype-distance pruning
                            [Sorscher et al.'22] (App. I.8 comparison)

Model-dependent per-epoch strategies (selection uses the *current* model):

  CraigPBSelector         — per-batch CRAIG: facility location over last-layer
                            gradient similarity [Mirzasoleiman'20]
  GradMatchPBSelector     — per-batch GRAD-MATCH: OMP matching of the mean
                            gradient [Killamsetty'21]
  GlisterSelector         — greedy validation-gain selection [Killamsetty'21]

The model-dependent ones take ``grad_fn() -> (n, d)`` per-sample (proxy)
gradients, as a numpy array or a tensor, and ``val_grad_fn() -> (d,)``.
They run on the gradients' device (a numpy array goes to ``device``, the
card unless the caller asks for the CPU): CRAIG's greedy launches the
``fl_gains`` kernel (B4) on a card's Gram and takes its plain version on the
CPU; GRAD-MATCH and GLISTER run their greedy loops in float64, as the
reference does in numpy, without reading the device inside the loop.  Each
returns host ``int64`` indices, which synchronises the card, so a caller's
clock around it measures the work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.gram_free import make_gram_free_disparity_min
from repro_torch.core.greedy import greedy
from repro_torch.core.similarity import gram_matrix, normalize_rows
from repro_torch.core.submodular import disparity_min, make_facility_location_pallas
from repro_torch.device import resolve_device


# --------------------------------------------------------------------------
# selection math (shared by the legacy classes and repro_torch.selection)
# --------------------------------------------------------------------------

def _normalize_weights(w: np.ndarray) -> np.ndarray:
    """Scale weights to mean 1 so the weighted loss keeps its usual scale."""
    w = np.asarray(w, np.float32)
    total = float(w.sum())
    if not np.isfinite(total) or total <= 0.0:
        return np.ones_like(w)
    return w * (len(w) / total)


def _on_device(a: Any, device: str | torch.device) -> torch.Tensor:
    """A tensor stays where it is; an array goes to ``device``."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=resolve_device(device))


def _host_indices(idx: torch.Tensor) -> np.ndarray:
    return idx.cpu().numpy().astype(np.int64)


def craig_pb_select(g: Any, k: int, *, device: str | torch.device = "cuda"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """CRAIG: facility-location medoids of the gradient-similarity kernel.

    Returns (indices, weights) where weight_j is the mass of the cluster
    represented by medoid j (CRAIG's γ coefficients), normalized to mean 1.
    The (n, n) Gram is the plain product, as in the reference; the greedy's
    gains are ``fl_gains`` (B4, one launch a step on the card; its plain
    version on the CPU).
    """
    K = gram_matrix(_on_device(g, device))
    idx = greedy(make_facility_location_pallas(), K, k).indices
    # every sample is "covered" by its most similar medoid (the first on a
    # tie, as jnp.argmax); the medoid's loss weight is how many samples it
    # stands in for.  Only the (k,) counts cross to the host.
    counts = torch.bincount(K[:, idx].argmax(dim=1), minlength=k)
    w = counts.cpu().numpy().astype(np.float32)
    return _host_indices(idx), _normalize_weights(w)


def _exclude(scores: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    return scores.masked_fill_(chosen, -torch.inf)


def gradmatch_omp_select(g: Any, k: int, lam: float = 0.5, *,
                         device: str | torch.device = "cuda"
                         ) -> tuple[np.ndarray, np.ndarray]:
    """GRAD-MATCH: OMP-style matching of the mean gradient.

    Returns (indices, weights) with the non-negative OMP coefficients as
    weights (normalized to mean 1).
    """
    g = _on_device(g, device).double()
    residual = g.mean(0)
    chosen = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    idx = torch.empty((k,), dtype=torch.int64, device=g.device)
    coefs = torch.empty((k,), dtype=torch.float64, device=g.device)
    for t in range(k):
        j = _exclude(g @ residual, chosen).argmax().view(1)
        chosen.scatter_(0, j, True)
        gj = g.index_select(0, j)[0]
        # per-element weight via nonneg projection (simplified OMP)
        w = torch.clamp((gj @ residual) / (gj @ gj + lam), min=0.0)
        idx[t:t + 1] = j
        coefs[t] = w
        residual = residual - w * gj
    return _host_indices(idx), _normalize_weights(coefs.cpu().numpy())


def glister_select(g: Any, gv: Any, k: int, eta: float = 0.1, *,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """GLISTER: greedy validation-gain selection (bilevel approximation):
    score(j) ≈ <g_j, g_val> taken greedily with residual updates."""
    g = _on_device(g, device).double()
    gv = _on_device(gv, g.device).to(device=g.device, dtype=torch.float64)
    chosen = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    idx = torch.empty((k,), dtype=torch.int64, device=g.device)
    acc = torch.zeros_like(gv)
    for t in range(k):
        # validation gain if j's gradient step is added
        j = _exclude(g @ (gv - eta * acc), chosen).argmax().view(1)
        chosen.scatter_(0, j, True)
        idx[t:t + 1] = j
        acc = acc + g.index_select(0, j)[0]
    return _host_indices(idx)


def prototype_distances(z: torch.Tensor, protos: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Lloyd iterations from ``protos``, then each row's squared distance to
    its nearest prototype.  The distance keeps the reference's
    ``(z − p)²`` form, not the ``|z|² − 2z·p + |p|²`` expansion; a
    prototype whose cluster empties keeps its place; the cluster means are
    one product with the assignment's one-hot, so no step reads the device."""
    n_protos = protos.shape[0]
    ids = torch.arange(n_protos, device=z.device)
    for _ in range(iters):
        assign = ((z[:, None] - protos[None]) ** 2).sum(-1).argmin(1)
        onehot = (assign[:, None] == ids).to(z.dtype)
        counts = onehot.sum(0)
        means = (onehot.T @ z) / counts.clamp_min(1)[:, None]
        protos = torch.where((counts > 0)[:, None], means, protos)
    return ((z[:, None] - protos[None]) ** 2).sum(-1).min(1).values


# --------------------------------------------------------------------------
# model-independent baselines
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RandomSelector:
    n: int
    k: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._idx = rng.choice(self.n, size=self.k, replace=False)

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        return self._idx


@dataclasses.dataclass
class AdaptiveRandomSelector:
    n: int
    k: int
    R: int = 1
    seed: int = 0

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        window = epoch // self.R
        rng = np.random.default_rng(self.seed * 7919 + window)
        return rng.choice(self.n, size=self.k, replace=False)


@dataclasses.dataclass
class MiloFixedSelector:
    """Fixed subset maximizing disparity-min over frozen-encoder features.

    The dense route builds the (n, n) rescaled-cosine Gram with a plain
    ``torch`` product (the reference builds it outside any Pallas kernel
    too); ``gram_free=True`` runs the selection directly over row-normalized
    features (O(n·d) memory) — identical trajectories, see
    ``repro_torch.core.gram_free``.  The greedy runs on ``device`` (the card
    unless the caller asks for the CPU).  ``shard_selection=True`` is not
    ported yet (ROADMAP A11).
    """

    features: np.ndarray
    k: int
    gram_free: bool = False
    shard_selection: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.shard_selection:
            raise NotImplementedError(
                "milo_fixed with shard_selection=True is not ported yet "
                "(ROADMAP A11, multi-device selection)")
        z = torch.as_tensor(np.asarray(self.features, np.float32),
                            device=resolve_device(self.device))
        if self.gram_free:
            res = greedy(make_gram_free_disparity_min(), normalize_rows(z), self.k)
        else:
            res = greedy(disparity_min, gram_matrix(z), self.k)
        self._idx = _host_indices(res.indices)

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        return self._idx


@dataclasses.dataclass
class EL2NSelector:
    """Data-diet scoring: EL2N = ||p - onehot(y)||2, computed from an early
    model snapshot; keeps hardest (or easiest) k.  Sorting n scores is host
    work, as in the reference (numpy, the same order on ties)."""

    scores: np.ndarray
    k: int
    keep: str = "hard"  # hard | easy

    def __post_init__(self):
        order = np.argsort(self.scores)
        self._idx = (order[-self.k:] if self.keep == "hard" else order[: self.k]).astype(np.int64)

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        return self._idx


@dataclasses.dataclass
class SelfSupPruneSelector:
    """[Sorscher'22]: k-means prototypes in feature space; prune by distance
    to the nearest prototype (keep hardest = farthest for large budgets).

    The prototypes start from the reference's numpy draw; the Lloyd
    iterations and distances run on ``device`` in the features' dtype
    (``prototype_distances``), and the (n,) distances are ranked on the
    host with the reference's ``np.argsort``."""

    features: np.ndarray
    k: int
    n_prototypes: int = 10
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        z = _on_device(self.features, self.device)
        first = rng.choice(len(z), self.n_prototypes, replace=False)
        protos = z[torch.as_tensor(first, device=z.device)]
        dist = prototype_distances(z, protos).cpu().numpy()
        self._idx = np.argsort(dist)[-self.k:].astype(np.int64)  # hardest

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        return self._idx


# --------------------------------------------------------------------------
# model-dependent baselines (selection on the training critical path)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CraigPBSelector:
    """Facility location over per-sample gradient similarity, every R epochs."""

    grad_fn: Callable[[], Any]   # () -> (n, d) current per-sample grads
    k: int
    R: int = 10
    selection_time: float = 0.0
    device: str | torch.device = "cuda"

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        if epoch % self.R == 0 or not hasattr(self, "_idx"):
            t0 = time.perf_counter()
            self._idx, self._weights = craig_pb_select(self.grad_fn(), self.k,
                                                       device=self.device)
            self.selection_time += time.perf_counter() - t0
        return self._idx


@dataclasses.dataclass
class GradMatchPBSelector:
    """OMP-style matching of the mean gradient, every R epochs."""

    grad_fn: Callable[[], Any]
    k: int
    R: int = 10
    lam: float = 0.5
    selection_time: float = 0.0
    device: str | torch.device = "cuda"

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        if epoch % self.R == 0 or not hasattr(self, "_idx"):
            t0 = time.perf_counter()
            self._idx, self._weights = gradmatch_omp_select(
                self.grad_fn(), self.k, self.lam, device=self.device
            )
            self.selection_time += time.perf_counter() - t0
        return self._idx


@dataclasses.dataclass
class GlisterSelector:
    """Greedy maximization of validation-set gain (bilevel approximation)."""

    grad_fn: Callable[[], Any]
    val_grad_fn: Callable[[], Any]
    k: int
    R: int = 10
    eta: float = 0.1
    selection_time: float = 0.0
    device: str | torch.device = "cuda"

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        if epoch % self.R == 0 or not hasattr(self, "_idx"):
            t0 = time.perf_counter()
            self._idx = glister_select(
                self.grad_fn(), self.val_grad_fn(), self.k, self.eta, device=self.device
            )
            self.selection_time += time.perf_counter() - t0
        return self._idx
