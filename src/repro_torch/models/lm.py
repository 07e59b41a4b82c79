"""Decoder-only language model: embed → blocks → norm → logits.  The port of
``repro/models/lm.py``.

The reference stacks its ``n_groups`` identical groups and scans them; here
the ``num_layers`` blocks run in an explicit loop, and the caches are a
per-layer list with the batch at dim 0.

The weights are one tree of tensors in the reference's nested layout —
``{"embed", "final_norm", "groups": {"b<i>": {...}}}`` — whose
group-stacked leaves are ``tree.Stacked`` lists of the groups' tensors, so a
layer reads its own tensor without a slice.  Serving reads the tree as it
is; training differentiates it (gradients flow to the tensors that require
them) and a checkpoint stacks it back into the reference's arrays.

Entry points:
  init_lm(cfg, seed=0, device="cuda")            -> params
  params_from_jax(params, cfg, device="cuda")    -> params  (the reference's weights)
  params_to_jax(params)                          -> the reference's tree, numpy
  layer_params(params, cfg)                      -> per-layer block weights
  forward(params, cfg, tokens, ...)              -> (logits, caches)
  loss_fn(params, cfg, batch)                    -> (loss, metrics)
  init_caches(cfg, batch, cache_len, device)     -> caches
  prefill(params, cfg, tokens, caches)           -> (logits, caches)
  decode_step(params, cfg, token, caches, pos)   -> (logits, caches)

Encoder-decoder models and a ``context`` (cross-attention) raise.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import apply_block, init_block, init_block_cache
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import embed, init_embedding, rms_norm, unembed
from repro_torch.tree import Stacked


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_config(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP A12)")


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer: the pattern repeated ``n_groups`` times."""
    return list(cfg.pattern) * cfg.n_groups


def init_lm(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the port's own draws: not the reference's numbers), layer
    by layer: ``embed`` (V, D) (tied unembedding), the blocks, ``final_norm``."""
    _check_config(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    blocks = [init_block(gen, cfg, mixer, ffn, dtype) for mixer, ffn in layer_kinds(cfg)]
    p = len(cfg.pattern)
    groups = {f"b{i}": _stack_dicts(blocks[i::p]) for i in range(p)}
    return {"embed": table, "groups": groups,
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)}


def _to_torch(arr, device) -> torch.Tensor:
    """A numpy array (as ``np.asarray`` gives it from a JAX array) to a
    tensor, bit for bit.  JAX's bf16 comes as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, or as its raw 2-byte payload (``V2``, as
    ``params_to_jax`` and ``np.load`` give it): its bits go through int16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bit for bit; bf16 as its raw 2-byte payload
    (``V2``), the bytes ``np.save`` writes for ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _stack_dicts(nodes: list) -> dict | Stacked:
    if isinstance(nodes[0], dict):
        return {k: _stack_dicts([n[k] for n in nodes]) for k in nodes[0]}
    return Stacked(nodes)


def _unstack(node, g: int):
    if isinstance(node, dict):
        return {k: _unstack(v, g) for k, v in node.items()}
    return node[g]


def params_from_jax(params: dict, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_lm`` params (a pytree of numpy arrays) as the
    port's: every group-stacked leaf unstacked along its leading axis, so
    layer ``g * len(pattern) + i`` reads index ``g`` of ``groups["b<i>"]``."""
    _check_config(cfg)
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return Stacked(_to_torch(node, dev).unbind(0))

    return {"embed": _to_torch(params["embed"], dev), "groups": conv(params["groups"]),
            "final_norm": _to_torch(params["final_norm"], dev)}


def params_to_jax(params: dict) -> dict:
    """The inverse of ``params_from_jax``: the reference's nested,
    group-stacked params tree as numpy arrays (bf16 as raw ``V2``)."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, Stacked):
            return np.stack([_to_numpy(t) for t in node])
        return _to_numpy(node)

    return conv(params)


def layer_params(params: dict, cfg: ModelConfig) -> list[dict]:
    """Each layer's block weights (the groups' tensors, unstacked by
    reference), in layer order."""
    p = len(cfg.pattern)
    return [_unstack(params["groups"][f"b{i}"], g)
            for g in range(cfg.n_groups) for i in range(p)]


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                # (B, S) integer
    *,
    context: torch.Tensor | None = None,
    mode: str = "train",
    caches: list | None = None,
    pos0: int | np.ndarray | torch.Tensor = 0,
) -> tuple[torch.Tensor, list | None]:
    """Logits (B, S, V) in the activation dtype, and the new caches
    (``None`` unless ``caches`` were given).  With ``cfg.remat`` and
    gradients on, each group of
    ``len(cfg.pattern)`` layers is recomputed in backward (the reference's
    ``jax.checkpoint`` around its scanned group)."""
    _check_config(cfg)
    if context is not None:
        raise NotImplementedError("a cross-attention context is not ported yet (ROADMAP A12)")
    table, final_norm = params["embed"], params["final_norm"]
    blocks = layer_params(params, cfg)
    dev = table.device
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    x = embed(tokens, table)
    if isinstance(pos0, int):   # no host-to-device copy (it would wait for the stream)
        positions = pos0 + torch.arange(s, device=dev)[None, :]
    else:
        p0 = torch.as_tensor(np.asarray(pos0) if not torch.is_tensor(pos0) else pos0, device=dev)
        p0 = p0[:, None] if p0.dim() == 1 else p0  # per-slot decode positions (B,)
        positions = p0 + torch.arange(s, device=dev)[None, :]
    kinds = layer_kinds(cfg)
    if caches is None and cfg.remat and torch.is_grad_enabled():
        p = len(cfg.pattern)

        def group(x, lo):
            for i in range(lo, lo + p):
                x, _ = apply_block(blocks[i], x, cfg=cfg, positions=positions, cache=None,
                                   mode=mode, kinds=kinds[i])
            return x

        for lo in range(0, len(blocks), p):
            x = checkpoint(group, x, lo, use_reentrant=False)
        new_caches = None
    else:
        new_caches: list | None = None if caches is None else []
        for i, block in enumerate(blocks):
            x, nc = apply_block(block, x, cfg=cfg, positions=positions,
                                cache=None if caches is None else caches[i], mode=mode,
                                kinds=kinds[i])
            if new_caches is not None:
                new_caches.append(nc)
    x = rms_norm(x, final_norm, cfg.norm_eps)
    return unembed(x, table), new_caches


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (the reference's ``loss_fn``).  ``batch``:
    tokens (B, S), labels (B, S), optional ``loss_mask`` (B, S), optional
    example ``weights`` (B,) (MILO's plan weights).

    The log-sum-exp runs over the f32-upcast shifted logits; the label's
    logit is gathered (the value the reference's one-hot contraction gives,
    without a (B, S, V) one-hot).  The loss is ``Σ nll · mask / max(Σ mask,
    1)`` with ``mask = loss_mask · weights[:, None]``."""
    logits, _ = forward(params, cfg, batch["tokens"], mode="train")
    dev = logits.device
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = (logits - m).float()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0].float()
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0].float()
    nll = lse - label_logit                                               # (B, S)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else torch.as_tensor(mask, device=dev)
    w = batch.get("weights")
    if w is not None:
        mask = mask * torch.as_tensor(w, device=dev)[:, None]
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss, {"loss": loss}


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device: str | torch.device = "cuda") -> list:
    """One zeroed cache per layer (batch at dim 0)."""
    dev = resolve_device(device)
    return [init_block_cache(cfg, mixer, batch, cache_len, _dtype(cfg), dev)
            for mixer, _ in layer_kinds(cfg)]


def prefill(params: dict, cfg: ModelConfig, tokens, caches: list, *, context=None):
    """The prompt's logits, and ``caches`` filled in place (K/V of the
    prompt, zeros past it; the final SSM states)."""
    return forward(params, cfg, tokens, context=context, mode="prefill", caches=caches)


def decode_step(params: dict, cfg: ModelConfig, token, caches: list, pos, *, context=None):
    """One decode step: token (B, 1); pos a scalar or (B,) per-slot
    positions.  The attention caches are updated in place.

    Raises before any write if a slot's cache is full (the reference's cache
    write would clamp the index instead).  That check reads the slots'
    lengths to the host once per step.
    """
    kv = next((c for c in caches if isinstance(c, KVCache)), None)
    if kv is not None:
        s = torch.as_tensor(token).shape[1]
        lengths = kv.length.cpu()
        if bool((lengths + s > kv.k.shape[1]).any()):
            raise ValueError(f"decode past the cache: slot lengths {lengths.tolist()} + {s} > "
                             f"{kv.k.shape[1]} positions")
    return forward(params, cfg, token, context=context, mode="decode", caches=caches, pos0=pos)
