"""LR schedules: cosine annealing (paper default), cyclic (ImageNet), linear
decay (tuning search space), constant, with optional linear warmup (port of
``repro.optim.schedules``).

Each schedule is a function of the step — an integer tensor (on the device,
so a captured graph reads it) or a Python int — returning an f32 0-dim
tensor on the step's device, computed in f32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine(base_lr: float, total_steps: int, warmup: int = 0, min_lr: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clip((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return fn


def cyclic(base_lr: float, max_lr: float, period: int):
    def fn(step):
        t = _f32(torch.as_tensor(step) % (2 * period))
        up = base_lr + (max_lr - base_lr) * (t / period)
        down = max_lr - (max_lr - base_lr) * ((t - period) / period)
        return torch.where(t < period, up, down)

    return fn


def linear_decay(base_lr: float, gamma: float, every: int):
    """Multiply lr by (1-gamma) every ``every`` steps (paper tuning space)."""
    def fn(step):
        k = _f32(torch.as_tensor(step) // every)
        return base_lr * (1.0 - gamma) ** k

    return fn


def constant(base_lr: float):
    def fn(step):
        return torch.full((), base_lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return fn


GET = {"cosine": cosine, "cyclic": cyclic, "linear_decay": linear_decay, "constant": constant}
