"""The benchmark's inputs, made from ``--seed``: the same seed gives the same
inputs.  Both the program and the reference take them from here.

- ``gaussian_mixture``: class clusters with dense cores and hard tails, the
  stand-in for a frozen encoder's features of an image data set (a copy of
  the generator of ``repro_torch.data.datasets.GaussianMixtureDataset``,
  draw for draw).
- ``token_corpus``: arithmetic-progression token documents and their
  64-bin histogram features (a copy of ``TokenLMDataset``, draw for draw).
- ``lm_weights``: an LM's weights drawn on the device in one call per
  distinct scale, in the dtype they are trained in.
"""
from __future__ import annotations

import numpy as np
import torch


def gaussian_mixture(n: int, n_classes: int, dim: int, seed: int, *,
                     tail_frac: float = 0.25, sep: float = 6.0) -> tuple[np.ndarray, np.ndarray]:
    """(features (n, dim) f32, labels (n,) int64), classes in order."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, dim)) * sep
    per = n // n_classes
    xs, ys = [], []
    for c in range(n_classes):
        n_tail = int(per * tail_frac)
        n_core = per - n_tail
        core = centers[c] + rng.normal(size=(n_core, dim))
        other = centers[(c + 1 + rng.integers(0, n_classes - 1, n_tail)) % n_classes]
        tail = centers[c] * 0.55 + other * 0.45 + rng.normal(size=(n_tail, dim)) * 1.5
        xs.append(np.concatenate([core, tail]))
        ys.append(np.full(per, c))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys).astype(np.int64)


class TokenCorpus:
    """Next-token documents of ``seq_len + 1`` tokens (inputs and labels)."""

    def __init__(self, n_docs: int, seq_len: int, vocab: int, seed: int):
        rng = np.random.default_rng(seed)
        base = rng.integers(0, vocab, size=(n_docs, 1))
        step = rng.integers(1, 7, size=(n_docs, 1))
        pos = np.arange(seq_len + 1)[None, :]
        self.tokens = ((base + step * pos) % vocab).astype(np.int32)
        noise = rng.random((n_docs, seq_len + 1)) < 0.05
        self.tokens[noise] = rng.integers(0, vocab, size=int(noise.sum()))
        self.n = n_docs

    def batch(self, idx: np.ndarray) -> dict:
        t = self.tokens[idx]
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def features(self) -> np.ndarray:
        """L2-normalised 64-bin histograms of each document's tokens."""
        n, L = self.tokens.shape
        f = np.zeros((n, 64), np.float32)
        rows = np.repeat(np.arange(n), L)
        np.add.at(f, (rows, (self.tokens % 64).ravel()), 1.0)
        f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-6)
        return f


def lm_leaf_specs(model: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every weight of a dense decoder in the
    layout the port trains (``layers.<i>.<part>``; ``kind`` is ``normal``
    for a matrix drawn at ``scale``, ``ones`` for a norm scale)."""
    d, f, v = model["hidden_size"], model["intermediate_size"], model["vocab_size"]
    h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // h
    specs = [("embed", (v, d), "normal", 0.02)]
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        specs += [
            (p + "norm1", (d,), "ones", 1.0),
            (p + "wq", (d, h, hd), "normal", (2.0 / (d + h * hd)) ** 0.5),
            (p + "wk", (d, hkv, hd), "normal", (2.0 / (d + hkv * hd)) ** 0.5),
            (p + "wv", (d, hkv, hd), "normal", (2.0 / (d + hkv * hd)) ** 0.5),
            (p + "wo", (h, hd, d), "normal", (2.0 / (h * hd + d)) ** 0.5),
            (p + "norm2", (d,), "ones", 1.0),
            (p + "w_gate", (d, f), "normal", (2.0 / (d + f)) ** 0.5),
            (p + "w_up", (d, f), "normal", (2.0 / (d + f)) ** 0.5),
            (p + "w_down", (f, d), "normal", (2.0 / (f + d)) ** 0.5),
        ]
    specs.append(("final_norm", (d,), "ones", 1.0))
    return specs


def lm_weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Every weight of ``lm_leaf_specs`` by name.  Matrices of one scale are
    views of one buffer filled by one ``normal_`` call on the device, the
    scales in the order they first appear; norm scales are f32 ones."""
    specs = lm_leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups: dict[float, list] = {}
    for name, shape, kind, scale in specs:
        if kind == "normal":
            groups.setdefault(scale, []).append((name, shape))
    out: dict[str, torch.Tensor] = {}
    for scale, members in groups.items():
        total = sum(int(np.prod(s)) for _, s in members)
        buf = torch.empty((total,), dtype=dtype, device=device).normal_(0.0, scale, generator=gen)
        off = 0
        for name, shape in members:
            n = int(np.prod(shape))
            out[name] = buf[off:off + n].view(shape)
            off += n
    for name, shape, kind, _ in specs:
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
    return out
