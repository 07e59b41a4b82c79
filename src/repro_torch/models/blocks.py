"""Transformer/SSM blocks: the port of ``repro/models/blocks.py``, forward
only.

A *block* is a pre-norm mixer (+ residual) then a pre-norm FFN
(+ residual).  Its weights live in an ``nn.Module`` whose parameter names
are the reference's (``norm1``, ``mixer.wq``, ``ffn.w_gate`` …), so the
reference's params carry over one for one.  Every block owns a cache slot:
a ``KVCache`` for attention, the SSM state for Mamba, ``None`` otherwise.

Ported mixers: ``attn`` and ``mamba``; FFNs: ``dense``, ``moe`` and
``none``.  Cross-attention (``xattn``), the encoder's ``attn_nc``, mLSTM
and sLSTM raise.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache, attention, init_attention
from repro_torch.models.layers import init_mlp, mlp, rms_norm
from repro_torch.models.ssm import init_mamba, mamba, mamba_state_shape

Cache = Any  # KVCache | torch.Tensor (SSM state) | None

_NOT_PORTED = {
    "xattn": "cross-attention (xattn) is not ported yet (ROADMAP A12)",
    "attn_nc": "the encoder's non-causal attention (attn_nc) is not ported yet (ROADMAP A12)",
    "mlstm": "the mLSTM mixer is not ported yet (ROADMAP A12)",
    "slstm": "the sLSTM mixer is not ported yet (ROADMAP A12)",
}


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One block's weights: ``norm1``, ``mixer`` and, unless the FFN is
    ``none``, ``norm2`` and ``ffn`` (parameter dicts of the reference's
    names)."""

    def __init__(self, mixer: str, ffn: str, params: dict):
        super().__init__()
        check_block_kinds(mixer, ffn)
        self.mixer_kind, self.ffn_kind = mixer, ffn
        self.norm1 = _frozen(params["norm1"])
        self.mixer = nn.ParameterDict({k: _frozen(v) for k, v in params["mixer"].items()})
        if ffn != "none":
            self.norm2 = _frozen(params["norm2"])
            self.ffn = nn.ParameterDict({k: _frozen(v) for k, v in params["ffn"].items()})


def check_block_kinds(mixer: str, ffn: str) -> None:
    if mixer in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[mixer])
    if mixer not in ("attn", "mamba"):
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(f"unknown ffn {ffn!r}")


def init_block(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str, dtype) -> Block:
    check_block_kinds(mixer, ffn)
    dev = gen.device
    p: dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)}
    if mixer == "attn":
        p["mixer"] = init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim, dtype)
    else:
        p["mixer"] = init_mamba(gen, cfg.d_model, expand=cfg.ssm_expand,
                                head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state_dim, dtype=dtype)
    if ffn != "none":
        p["norm2"] = torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)
        p["ffn"] = (init_mlp(gen, cfg.d_model, cfg.d_ff, dtype) if ffn == "dense"
                    else moe_mod.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, dtype))
    return Block(mixer, ffn, p)


def init_block_cache(cfg: ModelConfig, mixer: str, batch: int, cache_len: int, dtype,
                     device) -> Cache:
    """Zeroed cache for one block (length 0)."""
    check_block_kinds(mixer, "none")
    if mixer == "attn":
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros((batch,), dtype=torch.int32, device=device))
    return torch.zeros(mamba_state_shape(cfg.d_model, expand=cfg.ssm_expand,
                                         head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state_dim,
                                         batch=batch), dtype=torch.float32, device=device)


def apply_block(
    block: Block,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Cache,
    mode: str,
) -> tuple[torch.Tensor, Cache]:
    """One block over x (B, S, D).  Returns (x, the block's new cache):
    prefill fills ``cache`` (the template) in place, decode updates it."""
    mixer, ffn = block.mixer_kind, block.ffn_kind
    h = rms_norm(x, block.norm1, cfg.norm_eps)
    new_cache: Cache = None
    if mixer == "attn":
        y, kvc = attention(
            block.mixer, h, positions,
            causal=True,
            impl=cfg.attention_impl,
            rope_theta=cfg.rope_theta,
            use_rope=cfg.use_rope,
            cache=cache if mode == "decode" else None,
            mode=mode,
        )
        if mode == "decode":
            new_cache = kvc
        elif mode == "prefill":
            new_cache = _fit_cache(kvc, cache)
    else:
        # decode is the sequential one-token update whatever the impl
        y, st = mamba(block.mixer, h, chunk=cfg.ssm_chunk,
                      state=cache if mode == "decode" else None, mode=mode,
                      impl=cfg.ssm_impl if mode != "decode" else "chunked")
        if mode in ("prefill", "decode"):
            new_cache = st
    x = x + y

    if ffn == "dense":
        x = x + mlp(block.ffn, rms_norm(x, block.norm2, cfg.norm_eps))
    elif ffn == "moe":
        x = x + moe_mod.moe(
            block.ffn, rms_norm(x, block.norm2, cfg.norm_eps),
            top_k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
            group_size=cfg.moe_group_size,
            dropless=(mode == "decode"),  # tiny token count: exact routing
        )
    return x, new_cache


def _fit_cache(kvc: KVCache, template: Cache) -> KVCache:
    """Prefill K/V written into the template's max-length cache, in place:
    the first S positions hold the prompt's K/V, the rest are zero (the
    reference pads with zeros).  Without a template the K/V come back as
    they are."""
    if not isinstance(template, KVCache):
        return kvc
    max_len, cur = template.k.shape[1], kvc.k.shape[1]
    if cur > max_len:
        raise ValueError(f"a prompt of {cur} tokens does not fit a cache of {max_len} positions")
    for dst, src in ((template.k, kvc.k), (template.v, kvc.v)):
        dst[:, :cur].copy_(src)
        dst[:, cur:].zero_()
    template.length.copy_(kvc.length)
    return template
