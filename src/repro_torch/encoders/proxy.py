"""Proxy feature encoder (paper App. H.2), port of ``repro.encoders.proxy``:
a small model trained to convergence on the target dataset; penultimate
activations become the feature space for MILO's similarity kernel.

Used when the zero-shot pretrained encoders underperform (checked by linear
probing).  The fit is full-batch gradient descent with ``torch.autograd``
on the device (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense, init_dense


def _f32(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass
class ProxyEncoder:
    """Two-layer tanh MLP classifier; features = penultimate layer.

    The fields are the reference's; ``device`` is a keyword-only
    constructor argument, not a field.
    """

    d_in: int
    n_classes: int
    d_hidden: int = 128
    epochs: int = 60
    lr: float = 0.05
    seed: int = 0
    _: dataclasses.KW_ONLY
    device: dataclasses.InitVar[str | torch.device] = "cuda"

    def __post_init__(self, device):
        self.device = resolve_device(device)

    def init_params(self) -> dict[str, torch.Tensor]:
        """Scaled normal weights, zero biases, drawn from a CPU generator
        seeded with ``seed`` (the port's own draws: the reference's come
        from ``jax.random.PRNGKey(seed)``, which torch cannot replay)."""
        gen = torch.Generator().manual_seed(self.seed)
        return {
            "w1": init_dense(gen, self.d_in, self.d_hidden, torch.float32),
            "b1": torch.zeros((self.d_hidden,)),
            "w2": init_dense(gen, self.d_hidden, self.n_classes, torch.float32),
            "b2": torch.zeros((self.n_classes,)),
        }

    def fit(self, x: Any, y: Any, *, params0: dict | None = None) -> "ProxyEncoder":
        """``epochs`` full-batch steps ``p ← p − lr·∇p`` of the mean
        cross-entropy.  ``params0`` (keyword-only; arrays or tensors with
        the keys of ``init_params``) replaces the initial draw, which is how
        the parity tests start from the reference's parameters."""
        dev = self.device
        start = self.init_params() if params0 is None else params0
        params = {k: _f32(v, dev).clone().requires_grad_(True) for k, v in start.items()}
        xt = _f32(x, dev)
        yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
        for _ in range(self.epochs):
            loss = F.cross_entropy(self._logits(params, xt), yt)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    p.sub_(self.lr * g)
        self.params = {k: v.detach() for k, v in params.items()}
        return self

    @staticmethod
    def _hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(dense(x, p["w1"]) + p["b1"])

    def _logits(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return dense(self._hidden(p, x), p["w2"]) + p["b2"]

    @torch.no_grad()
    def encode(self, x: Any) -> np.ndarray:
        return self._hidden(self.params, _f32(x, self.device)).cpu().numpy()

    @torch.no_grad()
    def linear_probe_accuracy(self, x: Any, y: Any) -> float:
        logits = self._logits(self.params, _f32(x, self.device))
        yt = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        return float((logits.argmax(-1) == yt).float().mean())
