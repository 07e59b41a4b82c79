"""Abstract inputs of a dry run cell (port of ``repro.launch.specs``):
DTensors whose local shards are fake tensors, laid out by the LM rules
(``distributed.sharding``), allocating nothing.

Call these inside ``FakeTensorMode`` with a mesh over a (fake) process
group.  For each (arch, shape) cell they build what its step consumes:

  train    -> (TrainState, batch{tokens, labels [, context]})
  prefill  -> (params, batch{tokens [, context]}, caches)
  decode   -> (params, caches, batch{token, pos [, context]})

Parameters by ``param_shardings``; the optimizer's moments as their
parameters (FSDP), its scalars and the step replicated; KV caches by
``cache_spec``, SSM and mLSTM states by ``ssm_state_spec``, the sLSTM's
(B, D) states over the batch axes when they divide it; batches by
``data_spec``.  ``context`` stands in for the modality frontends:
precomputed frame (encoder-decoder) or patch (``xattn``) embeddings.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models.attention import KVCache
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train import train_state as ts


def sharded(shape, dtype, mesh, pls) -> DTensor:
    """A DTensor of global ``shape`` laid out by ``pls`` whose local shard
    is a new (fake, under ``FakeTensorMode``) tensor."""
    local = list(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            if local[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split over {pls}")
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, list(pls), run_check=False)


def _replicated(shape, dtype, mesh) -> DTensor:
    return sharded(shape, dtype, mesh, [Replicate()] * mesh.ndim)


def _lay_out(tree: Any, shardings: Any, mesh) -> Any:
    if isinstance(tree, dict):
        return {k: _lay_out(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_lay_out(t, s, mesh) for t, s in zip(tree, shardings))
    return sharded(tree.shape, tree.dtype, mesh, shardings)


def abstract_params(cfg: ModelConfig, mesh) -> Any:
    """The model's parameters at full size, laid out by ``param_shardings``."""
    full = lm.init_lm(cfg, device="cpu")
    return _lay_out(full, shd.param_shardings(mesh, full), mesh)


def abstract_train_state(cfg: ModelConfig, mesh, opt: Optimizer) -> ts.TrainState:
    """Parameters, the optimizer's state (``opt.init`` of the sharded
    parameters: moments laid out as their parameters; a plain scalar
    replicated) and the step."""
    params = abstract_params(cfg, mesh)
    opt_state = T.map(lambda t: t if isinstance(t, DTensor) else _replicated(t.shape, t.dtype, mesh),
                      opt.init(params))
    return ts.TrainState(params, opt_state, _replicated((), torch.int32, mesh))


def cache_placements(mesh, caches: list) -> list:
    """Placements of ``lm.init_caches``' caches: one entry per layer, of
    the cache's structure (a ``KVCache`` as (k, v, length))."""
    out: list = []
    ax = shd.batch_axes(mesh)
    for c in caches:
        if isinstance(c, KVCache):
            b, s, h, _ = c.k.shape
            kv = shd.cache_spec(mesh, b, s, h)
            out.append((kv, kv, (Replicate(),) * mesh.ndim))
        elif isinstance(c, tuple):      # sLSTM (c, n, m), each (B, D)
            b = c[0].shape[0]
            pls = shd.placements(mesh, (shd.maybe(mesh, b, ax), None))
            out.append((pls,) * len(c))
        elif c is not None:             # Mamba (B, H, N, P), mLSTM (B, H, P, P)
            out.append(shd.ssm_state_spec(mesh, c.shape[0], c.shape[1]))
        else:
            out.append(None)
    return out


def lay_out_caches(caches: list, pls: list, make) -> list:
    """``caches`` with every tensor ``t`` replaced by ``make(t, its
    placements)``."""
    out: list = []
    for c, p in zip(caches, pls):
        if isinstance(c, KVCache):
            out.append(KVCache(make(c.k, p[0]), make(c.v, p[1]), make(c.length, p[2])))
        elif isinstance(c, tuple):
            out.append(tuple(make(t, q) for t, q in zip(c, p)))
        elif c is not None:
            out.append(make(c, p))
        else:
            out.append(None)
    return out


def abstract_caches(cfg: ModelConfig, mesh, batch: int, cache_len: int) -> list:
    caches = lm.init_caches(cfg, batch, cache_len, device="cpu")
    return lay_out_caches(caches, cache_placements(mesh, caches),
                          lambda t, p: sharded(t.shape, t.dtype, mesh, p))


def _context(cfg: ModelConfig, mesh, b: int) -> DTensor | None:
    n = cfg.encoder_seq if cfg.is_encdec else cfg.num_context_tokens
    if not n:
        return None
    return sharded((b, n, cfg.d_model), torch.bfloat16, mesh, shd.data_spec(mesh, b, 2))


def train_batch_specs(cfg: ModelConfig, mesh, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    pls = shd.data_spec(mesh, b, 1)
    batch = {"tokens": sharded((b, s), torch.int32, mesh, pls),
             "labels": sharded((b, s), torch.int32, mesh, pls)}
    ctx = _context(cfg, mesh, b)
    if ctx is not None:
        batch["context"] = ctx
    return batch


def decode_batch_specs(cfg: ModelConfig, mesh, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    batch = {"token": sharded((b, 1), torch.int32, mesh, shd.data_spec(mesh, b, 1)),
             "pos": _replicated((), torch.int32, mesh)}
    ctx = _context(cfg, mesh, b)
    if ctx is not None:
        batch["context"] = ctx
    return batch


def input_specs(cfg: ModelConfig, mesh, shape: ShapeConfig, opt: Optimizer) -> tuple:
    """Everything the cell's step consumes, abstract."""
    if shape.kind == "train":
        return abstract_train_state(cfg, mesh, opt), train_batch_specs(cfg, mesh, shape)
    params = abstract_params(cfg, mesh)
    caches = abstract_caches(cfg, mesh, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        batch = train_batch_specs(cfg, mesh, shape)
        batch.pop("labels")
        return params, batch, caches
    return params, caches, decode_batch_specs(cfg, mesh, shape)
