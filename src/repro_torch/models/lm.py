"""Decoder-only language model: embed → blocks → norm → logits.  The port of
``repro/models/lm.py`` for serving (forward only).

The reference stacks its ``n_groups`` identical groups and scans them; here
the ``num_layers`` blocks are an ``nn.ModuleList`` run by an explicit loop,
and the caches are a per-layer list with the batch at dim 0.

Entry points:
  init_lm(cfg, seed=0, device="cuda")            -> LM
  params_from_jax(params, cfg, device="cuda")    -> LM  (the reference's weights)
  forward(model, cfg, tokens, ...)               -> (logits, caches)
  init_caches(cfg, batch, cache_len, device)     -> caches
  prefill(model, cfg, tokens, caches)            -> (logits, caches)
  decode_step(model, cfg, token, caches, pos)    -> (logits, caches)

Training (``loss_fn``) waits for the training slice; encoder-decoder
models and a ``context`` (cross-attention) raise.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import Block, _frozen, apply_block, init_block, init_block_cache
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import embed, init_embedding, rms_norm, unembed


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_config(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP A12)")


class LM(nn.Module):
    """The model's weights: ``embed`` (V, D) (tied unembedding), ``blocks``
    (one per layer, ``num_layers`` of them) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, embed_table: torch.Tensor, blocks: list[Block],
                 final_norm: torch.Tensor):
        super().__init__()
        _check_config(cfg)
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.num_layers} layers")
        self.cfg = cfg
        self.embed = _frozen(embed_table)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer: the pattern repeated ``n_groups`` times."""
    return list(cfg.pattern) * cfg.n_groups


@torch.no_grad()
def init_lm(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = "cuda") -> LM:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the port's own draws: not the reference's numbers)."""
    _check_config(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    blocks = [init_block(gen, cfg, mixer, ffn, dtype) for mixer, ffn in layer_kinds(cfg)]
    return LM(cfg, table, blocks, torch.ones((cfg.d_model,), dtype=torch.float32, device=dev))


def _to_torch(arr, device) -> torch.Tensor:
    """A numpy array (as ``np.asarray`` gives it from a JAX array) to a
    tensor, bit for bit.  JAX's bf16 comes as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses: its bits go through int16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def params_from_jax(params: dict, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> LM:
    """The reference's ``init_lm`` params (a pytree of numpy arrays) as the
    port's model.  Layer ``g * len(pattern) + i`` takes group ``g`` of
    ``params["groups"][f"b{i}"]`` (the leading ``n_groups`` axis unstacked)."""
    _check_config(cfg)
    dev = resolve_device(device)

    def tree(node, g):
        if isinstance(node, dict):
            return {k: tree(v, g) for k, v in node.items()}
        return _to_torch(np.asarray(node)[g], dev)

    blocks = []
    for g in range(cfg.n_groups):
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            blocks.append(Block(mixer, ffn, tree(params["groups"][f"b{i}"], g)))
    return LM(cfg, _to_torch(params["embed"], dev), blocks, _to_torch(params["final_norm"], dev))


@torch.no_grad()
def forward(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,                # (B, S) integer
    *,
    context: torch.Tensor | None = None,
    mode: str = "train",
    caches: list | None = None,
    pos0: int | np.ndarray | torch.Tensor = 0,
) -> tuple[torch.Tensor, list | None]:
    """Logits (B, S, V) in the activation dtype, and the new caches
    (``None`` unless ``caches`` were given)."""
    _check_config(cfg)
    if context is not None:
        raise NotImplementedError("a cross-attention context is not ported yet (ROADMAP A12)")
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    x = embed(tokens, model.embed)
    p0 = torch.as_tensor(np.asarray(pos0) if not torch.is_tensor(pos0) else pos0, device=dev)
    p0 = p0[:, None] if p0.dim() == 1 else p0  # per-slot decode positions (B,)
    positions = p0 + torch.arange(s, device=dev)[None, :]
    new_caches: list | None = None if caches is None else []
    for i, block in enumerate(model.blocks):
        x, nc = apply_block(block, x, cfg=cfg, positions=positions,
                            cache=None if caches is None else caches[i], mode=mode)
        if new_caches is not None:
            new_caches.append(nc)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed(x, model.embed), new_caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device: str | torch.device = "cuda") -> list:
    """One zeroed cache per layer (batch at dim 0)."""
    dev = resolve_device(device)
    return [init_block_cache(cfg, mixer, batch, cache_len, _dtype(cfg), dev)
            for mixer, _ in layer_kinds(cfg)]


def prefill(model: LM, cfg: ModelConfig, tokens, caches: list, *, context=None):
    """The prompt's logits, and ``caches`` filled in place (K/V of the
    prompt, zeros past it; the final SSM states)."""
    return forward(model, cfg, tokens, context=context, mode="prefill", caches=caches)


def decode_step(model: LM, cfg: ModelConfig, token, caches: list, pos, *, context=None):
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
    return forward(model, cfg, token, context=context, mode="decode", caches=caches, pos0=pos)
