"""Synthetic datasets for the smoke run and the tests (a copy of
``GaussianMixtureDataset`` from ``repro.data.datasets``; numpy only, so the
same seed gives the same data in both packages).

``GaussianMixtureDataset`` — c well-separated class clusters with dense cores
and sparse tails, so representation vs diversity set functions behave as in
the paper (graph-cut picks core/"easy", disparity picks tail/"hard"
samples), with a linear-probe-able label structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GaussianMixtureDataset:
    """Classification with dense cores + sparse hard tails per class."""

    n: int = 2000
    n_classes: int = 10
    dim: int = 32
    tail_frac: float = 0.25     # fraction of "hard" tail samples per class
    sep: float = 6.0            # inter-class center separation
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        centers = rng.normal(size=(self.n_classes, self.dim)) * self.sep
        per = self.n // self.n_classes
        xs, ys, hard = [], [], []
        for c in range(self.n_classes):
            n_tail = int(per * self.tail_frac)
            n_core = per - n_tail
            core = centers[c] + rng.normal(size=(n_core, self.dim))
            # tail: drawn toward *other* classes (boundary / hard samples)
            other = centers[(c + 1 + rng.integers(0, self.n_classes - 1, n_tail)) % self.n_classes]
            tail = centers[c] * 0.55 + other * 0.45 + rng.normal(size=(n_tail, self.dim)) * 1.5
            xs.append(np.concatenate([core, tail]))
            ys.append(np.full(per, c))
            hard.append(np.concatenate([np.zeros(n_core, bool), np.ones(n_tail, bool)]))
        self.x = np.concatenate(xs).astype(np.float32)
        self.y = np.concatenate(ys).astype(np.int64)
        self.is_hard = np.concatenate(hard)
        self.n = len(self.x)

    def features(self) -> np.ndarray:
        """Frozen-encoder features (identity here: x already lives in a
        semantically meaningful space, like DINO embeddings do for images)."""
        return self.x

    def split(self, val_frac: float = 0.1, test_frac: float = 0.2, seed: int = 42):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.n)
        n_test = int(self.n * test_frac)
        n_val = int(self.n * val_frac)
        return (
            idx[n_test + n_val:],
            idx[n_test : n_test + n_val],
            idx[:n_test],
        )
