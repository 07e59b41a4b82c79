"""Subset-selection baselines from the paper's experiments (port of
``repro.baselines.selectors``, ``MiloFixedSelector`` only).

``MiloFixedSelector`` exposes the legacy ``indices_for_epoch`` protocol;
``build_selector("milo_fixed", ...)`` wraps it in a ``SelectionPlan``.
EL2N, self-supervised pruning and the model-dependent baselines (CRAIG,
GRAD-MATCH, GLISTER) are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gram_free import make_gram_free_disparity_min
from repro_torch.core.greedy import greedy
from repro_torch.core.similarity import gram_matrix, normalize_rows
from repro_torch.core.submodular import disparity_min
from repro_torch.device import resolve_device


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
        self._idx = res.indices.cpu().numpy().astype(np.int64)

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        return self._idx
