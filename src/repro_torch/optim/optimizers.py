"""Optimizers: Nesterov SGD (paper's vision setup), Adam, AdamW (port of
``repro.optim.optimizers``).

Pure transforms of trees of tensors (``repro_torch.tree``) with the
reference's (init, update) pair: ``update`` returns new tensors and leaves
its inputs as they were; it works one leaf at a time (the reference's
per-leaf arithmetic, in its order), so its temporaries stay one leaf's.  Dtypes are the reference's: moments and the
update in f32, the parameter cast back to its storage dtype; Adam's bias
corrections take the int32 step ``t``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as T


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _device(params: Any) -> torch.device:
    leaves = T.leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _per_leaf(fn, params: Any, *trees: Any) -> list[tuple]:
    """``fn`` over matching leaves, one leaf at a time: a leaf's f32
    temporaries are freed before the next leaf's are made (the update's
    peak memory is the new state plus one leaf's work, not a second f32
    copy of every gradient)."""
    return [fn(*xs) for xs in zip(T.leaves(params), *(T.leaves(t) for t in trees))]


def _trees(params: Any, outs: list[tuple]) -> list[Any]:
    return [T.unflatten(params, [o[i] for o in outs]) for i in range(len(outs[0]))]


def sgd_nesterov(momentum: float = 0.9, weight_decay: float = 5e-4) -> Optimizer:
    """Nesterov SGD + decoupled L2 (paper: lr .05, wd 5e-4, momentum .9)."""

    def init(params):
        return {"m": T.map(_zeros32, params)}

    def update(grads, state, params, lr):
        def leaf(p, g, m_):
            g32 = g.float() + weight_decay * p.float()
            m = momentum * m_ + g32
            step = g32 + momentum * m  # Nesterov lookahead
            return (p.float() - lr * step).to(p.dtype), m

        new_params, m = _trees(params, _per_leaf(leaf, params, grads, state["m"]))
        return new_params, {"m": m}

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (weight_decay > 0 => decoupled AdamW)."""

    def init(params):
        return {"m": T.map(_zeros32, params), "v": T.map(_zeros32, params),
                "t": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf

        def leaf(p, g, m_, v_):
            g32 = g.float()
            m = b1 * m_ + (1 - b1) * g32
            v = b2 * v_ + (1 - b2) * g32 * g32
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (p.float() - lr * step).to(p.dtype), m, v

        new_params, m, v = _trees(params, _per_leaf(leaf, params, grads, state["m"],
                                                    state["v"]))
        return new_params, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adamw(weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(weight_decay=weight_decay, **kw)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale ``grads`` to a global norm of at most ``max_norm``; the norm is
    an f32 sum over the leaves in the reference's leaf order."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in T.leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return T.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


GET = {"sgd": sgd_nesterov, "adam": adam, "adamw": adamw}
