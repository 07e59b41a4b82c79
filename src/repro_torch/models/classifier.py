"""Small MLP classifier of the session facade (port of
``repro.models.classifier``).

3-layer ReLU MLP with weights in the reference's ``(d_in, d_out)`` layout
(``x @ w + b``, ``repro/models/layers.py`` ``dense``), per-sample weighted
cross entropy ``sum(w * nll) / max(sum(w), 1)``, accuracy, and the
Nesterov-momentum update.  Parameters are a plain dict of tensors, keyed
like the reference's pytree, so ``params_from_jax`` carries a JAX
``init_mlp`` result across unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def _init_dense(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale


def init_mlp(generator: torch.Generator, d_in: int, n_classes: int, hidden: int = 64,
             *, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The reference's initialisation (scaled normal weights, zero biases),
    drawn from a CPU ``generator`` so it is the same on every device, then
    moved to ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    p = {
        "w1": _init_dense(generator, d_in, hidden), "b1": torch.zeros(hidden),
        "w2": _init_dense(generator, hidden, hidden), "b2": torch.zeros(hidden),
        "w3": _init_dense(generator, hidden, n_classes), "b3": torch.zeros(n_classes),
    }
    return {k: v.to(device) for k, v in p.items()}


def params_from_jax(np_params: dict[str, np.ndarray], device: str | torch.device) -> dict[str, torch.Tensor]:
    """Carry the JAX ``init_mlp`` parameters (as numpy arrays) across
    unchanged: same keys, same ``(d_in, d_out)`` layout, float32."""
    missing = set(_KEYS) - set(np_params)
    if missing:
        raise KeyError(f"MLP parameters missing {sorted(missing)}")
    return {k: torch.tensor(np.asarray(np_params[k], np.float32), device=device) for k in _KEYS}


def mlp_logits(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def weighted_nll(p: dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Plan-weighted cross entropy (the loss every selection plan feeds)."""
    lp = torch.log_softmax(mlp_logits(p, x), dim=-1)
    nll = -lp.gather(1, y[:, None])[:, 0]
    return (nll * w).sum() / w.sum().clamp_min(1.0)


@torch.no_grad()
def accuracy(p: dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (mlp_logits(p, x).argmax(-1) == y).float().mean()


@torch.no_grad()
def nesterov_update(params: dict[str, torch.Tensor], mom: dict[str, torch.Tensor],
                    grads: dict[str, torch.Tensor], lr: float | torch.Tensor,
                    beta: float = 0.9):
    """One Nesterov-momentum SGD step, in place (the reference returns new
    pytrees; updating the buffers saves a copy of every parameter).  ``lr``
    is a float or a 0-d tensor on the parameters' device (the session's
    schedule, computed on the device so a captured graph reads it there)."""
    for k, g in grads.items():
        m = mom[k].mul_(beta).add_(g)
        params[k].sub_(lr * (g + beta * m))
    return params, mom
