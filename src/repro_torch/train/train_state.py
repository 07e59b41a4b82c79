"""Train state and the LM's train / serve step factories (port of
``repro.train.train_state``).

The LM's parameters are the weight tree of ``models.lm`` (the reference's
nested layout, group-stacked leaves as ``tree.Stacked`` lists).  A step
differentiates ``lm.loss_fn`` with ``torch.autograd.grad`` over detached
views of the parameters and returns a new state; the one it was given is
left as it was.  A step is ``obs``'s root span ``train.step``: profiled (or
with ``obs.enable()``), it records its forward, backward, clip and
optimizer update and the model's spans inside them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import obs
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import lm
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # () int32


def init_train_state(cfg: ModelConfig, opt: Optimizer, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    """Random weights from ``seed`` (``lm.init_lm``'s draws), the
    optimizer's zero state and step 0, on ``device``."""
    params = lm.init_lm(cfg, seed=seed, device=device)
    dev = params["embed"].device
    return TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=dev))


def _loss_and_grads(params: Any, cfg: ModelConfig, batch: dict):
    """(loss, grads) of ``lm.loss_fn`` at ``params``; grads in the
    parameters' dtypes, as a tree of their structure."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        with obs.span("train.forward"):
            loss, _ = lm.loss_fn(T.unflatten(params, leaves), cfg, batch)
        with obs.span("train.backward", backward=True):
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), T.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt: Optimizer, lr_schedule, *,
                    grad_clip: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics): ``loss``,
    ``grad_norm`` (before clipping, when ``grad_clip``) and ``lr``."""

    def train_step(state: TrainState, batch: dict):
        with obs.step("train.step", device=state.step.device):
            loss, grads = _loss_and_grads(state.params, cfg, batch)
            metrics = {"loss": loss}
            if grad_clip:
                with obs.span("train.clip"):
                    grads, gnorm = clip_by_global_norm(grads, grad_clip)
                metrics["grad_norm"] = gnorm
            lr = lr_schedule(state.step)
            with obs.span("optim.update"):
                new_params, new_opt = opt.update(grads, state.opt_state, state.params, lr)
            metrics["lr"] = lr
            return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig, opt: Optimizer, lr_schedule, *,
                               accum: int, grad_clip: float = 1.0):
    """Gradient-accumulated step: batch dims are (accum, micro_batch, ...).

    Used by the elastic plan to preserve global batch on fewer devices.
    """

    def train_step(state: TrainState, batch: dict):
        with obs.step("train.step", device=state.step.device):
            grads = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          state.params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(accum):
                mb = {k: v[i] for k, v in batch.items()}
                loss, g = _loss_and_grads(state.params, cfg, mb)
                grads = T.map(torch.add, grads, g)
                loss_sum = loss_sum + loss
            grads = T.map(lambda g: g / accum, grads)
            if grad_clip:
                with obs.span("train.clip"):
                    grads, _ = clip_by_global_norm(grads, grad_clip)
            lr = lr_schedule(state.step)
            with obs.span("optim.update"):
                new_params, new_opt = opt.update(grads, state.opt_state, state.params, lr)
            return TrainState(new_params, new_opt, state.step + 1), {
                "loss": loss_sum / accum, "lr": lr,
            }

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, caches):
        logits, caches = lm.prefill(params, cfg, batch["tokens"], caches,
                                    context=batch.get("context"))
        # next-token for the last position of every request
        return _next_token(logits), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """decode: one new token against a KV cache of fixed length."""

    def serve_step(params, caches, batch):
        logits, caches = lm.decode_step(params, cfg, batch["token"], caches, batch["pos"],
                                        context=batch.get("context"))
        return _next_token(logits), caches

    return serve_step


def _next_token(logits: torch.Tensor) -> torch.Tensor:
    """The argmax of each request's last logits.  Under a mesh the row is
    gathered whole over the vocabulary's shards first (an argmax across
    shards is not a sum)."""
    return torch.argmax(constrain(logits[:, -1, :], "batch", None), dim=-1)
