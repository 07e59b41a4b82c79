"""Synthetic datasets for the examples, the smoke run and the tests (copies
of ``repro.data.datasets``; numpy only, so the same seed gives the same data
in both packages).

* ``GaussianMixtureDataset`` — c well-separated class clusters with dense
  cores and sparse tails, so representation vs diversity set functions
  behave as in the paper (graph-cut picks core/"easy", disparity picks
  tail/"hard" samples), with a linear-probe-able label structure.
* ``SyntheticTextDataset`` — token sequences from per-class Markov chains
  (a TREC6-like task), with encoder features = normalized bigram
  histograms (the frozen-encoder stand-in).
* ``TokenLMDataset`` — next-token LM documents for the LM examples.
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


@dataclasses.dataclass
class SyntheticTextDataset:
    """Per-class Markov-chain token sequences (TREC6-like 6-way task)."""

    n: int = 1200
    n_classes: int = 6
    vocab: int = 64
    seq_len: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class-specific transition matrices (sparse, peaked)
        self.trans = rng.dirichlet(np.full(self.vocab, 0.05), size=(self.n_classes, self.vocab))
        per = self.n // self.n_classes
        toks, ys = [], []
        for c in range(self.n_classes):
            for _ in range(per):
                seq = [int(rng.integers(self.vocab))]
                for _ in range(self.seq_len - 1):
                    seq.append(int(rng.choice(self.vocab, p=self.trans[c, seq[-1]])))
                toks.append(seq)
                ys.append(c)
        self.tokens = np.asarray(toks, np.int32)
        self.y = np.asarray(ys, np.int64)
        self.n = len(self.tokens)

    def features(self) -> np.ndarray:
        """Frozen-encoder stand-in: L2-normalized bigram histograms."""
        f = np.zeros((self.n, self.vocab * 8), np.float32)
        for i, seq in enumerate(self.tokens):
            for a, b in zip(seq[:-1], seq[1:]):
                f[i, (a * 131 + b) % f.shape[1]] += 1.0
        f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-6)
        return f

    def split(self, val_frac: float = 0.1, test_frac: float = 0.2, seed: int = 42):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.n)
        n_test = int(self.n * test_frac)
        n_val = int(self.n * val_frac)
        return idx[n_test + n_val:], idx[n_test : n_test + n_val], idx[:n_test]


@dataclasses.dataclass
class TokenLMDataset:
    """Synthetic next-token corpus for the LM substrate examples."""

    n_docs: int = 512
    seq_len: int = 128
    vocab: int = 256
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # structured: arithmetic-progression motifs the model can learn
        base = rng.integers(0, self.vocab, size=(self.n_docs, 1))
        step = rng.integers(1, 7, size=(self.n_docs, 1))
        pos = np.arange(self.seq_len + 1)[None, :]
        self.tokens = ((base + step * pos) % self.vocab).astype(np.int32)
        noise = rng.random((self.n_docs, self.seq_len + 1)) < 0.05
        self.tokens[noise] = rng.integers(0, self.vocab, size=int(noise.sum()))
        self.n = self.n_docs

    def batch(self, idx: np.ndarray) -> dict:
        t = self.tokens[idx]
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def features(self) -> np.ndarray:
        f = np.zeros((self.n, 64), np.float32)
        for i, seq in enumerate(self.tokens):
            np.add.at(f[i], seq % 64, 1.0)
        f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-6)
        return f
