"""Transformer/SSM blocks: the port of ``repro/models/blocks.py``.

A *block* is a pre-norm mixer (+ residual) then a pre-norm FFN
(+ residual).  Its weights are a dict of the reference's names (``norm1``,
``mixer.wq``, ``ffn.w_gate`` …), so the reference's params carry over one
for one; serving and training read the same tensors, and gradients flow to
those that require them.  Every block owns a cache slot: a ``KVCache`` for
causal attention, the recurrent state for Mamba (B, H, N, P), the mLSTM
(B, H, P, P) and the sLSTM (a tuple (c, n, m)), ``None`` for the encoder's
non-causal attention and for cross-attention, which recompute their keys and
values from the encoder's frames or the (fixed) context at every call.

Mixers: ``attn`` (causal), ``attn_nc`` (the encoder's non-causal),
``xattn`` (cross-attention to ``context``), ``mamba``, ``mlstm``,
``slstm``, and the port's own ``conv`` (LFM2's gated short convolution,
``short_conv``: train and prefill; no decode path); FFNs: ``dense``, ``moe``
and ``none``.  A ``HybridConfig`` adds QK-norm to attention, the experts'
own width and the dropless ``sigmoid_bias`` route of ``moe``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.hybrid import option
from repro_torch.distributed.sharding import constrain
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache, attention, init_attention
from repro_torch.models.layers import init_dense, init_mlp, mlp, rms_norm
from repro_torch.models.ssm import (
    init_mamba,
    init_mlstm,
    init_slstm,
    mamba,
    mamba_state_shape,
    mlstm,
    mlstm_state_shape,
    slstm,
    slstm_state,
)

Cache = Any  # KVCache | torch.Tensor (SSM state) | tuple (sLSTM state) | None

_MIXERS = ("attn", "attn_nc", "xattn", "mamba", "mlstm", "slstm", "conv")
_ATTENTION = ("attn", "attn_nc", "xattn")
_NO_CONV_DECODE = ("the conv mixer has no decode path: decoding through the short convolution's "
                   "state (its last conv_kernel - 1 gated inputs) is not ported; train, or "
                   "prefill without caches")


def check_block_kinds(mixer: str, ffn: str) -> None:
    if mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(f"unknown ffn {ffn!r}")


def init_short_conv(gen: torch.Generator, d_model: int, kernel: int, dtype) -> dict:
    """``in_proj`` (D, 3D) giving B, C and x, the depthwise ``conv`` (D, K)
    drawn uniform in ±1/√K (PyTorch's default for a fan-in of K) and held
    in f32 (as the norm scales: K numbers a channel), and ``out_proj``
    (D, D); no biases."""
    bound = kernel ** -0.5
    conv = (torch.rand((d_model, kernel), generator=gen, device=gen.device) * 2 - 1) * bound
    return {"in_proj": init_dense(gen, d_model, 3 * d_model, dtype),
            "conv": conv,
            "out_proj": init_dense(gen, d_model, d_model, dtype)}


def short_conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LFM2's gated short convolution over x (B, S, D): (B, C, x) =
    x·in_proj, y = out_proj(C ⊙ conv(B ⊙ x)), the convolution causal and
    depthwise, tap K-1 on the current token and tap K-1-j on the token j
    back.  The gating and the taps run in f32, rounded once before
    ``out_proj``."""
    bb, c, xx = (x @ p["in_proj"]).chunk(3, dim=-1)
    w = p["conv"].float()
    k = w.shape[1]
    s = x.shape[1]
    u = F.pad(bb.float() * xx.float(), (0, 0, k - 1, 0))
    y = u[:, k - 1:] * w[:, k - 1]
    for j in range(k - 1):
        y = y + u[:, j:j + s] * w[:, j]
    return (c.float() * y).to(x.dtype) @ p["out_proj"]


def init_block(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str, dtype) -> dict:
    """One block's weights: ``norm1``, ``mixer`` and, unless the FFN is
    ``none``, ``norm2`` and ``ffn``."""
    check_block_kinds(mixer, ffn)
    dev = gen.device
    p: dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)}
    if mixer in _ATTENTION:
        p["mixer"] = init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim, dtype, qk_norm=option(cfg, "qk_norm"))
    elif mixer == "conv":
        p["mixer"] = init_short_conv(gen, cfg.d_model, option(cfg, "conv_kernel"), dtype)
    elif mixer == "mamba":
        p["mixer"] = init_mamba(gen, cfg.d_model, expand=cfg.ssm_expand,
                                head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state_dim, dtype=dtype)
    elif mixer == "mlstm":
        p["mixer"] = init_mlstm(gen, cfg.d_model, expand=cfg.ssm_expand,
                                head_dim=cfg.ssm_head_dim, dtype=dtype)
    else:
        p["mixer"] = init_slstm(gen, cfg.d_model, dtype=dtype)
    if ffn != "none":
        p["norm2"] = torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)
        if ffn == "dense":
            p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
        else:
            routed = option(cfg, "router") == "sigmoid_bias"
            p["ffn"] = moe_mod.init_moe(gen, cfg.d_model, option(cfg, "moe_d_ff"),
                                        cfg.num_experts, dtype, held=option(cfg, "n_held"),
                                        expert_bias=routed)
    return p


def init_block_cache(cfg: ModelConfig, mixer: str, batch: int, cache_len: int, dtype,
                     device) -> Cache:
    """Zeroed cache for one block (length 0); ``None`` for the stateless
    ``attn_nc`` and ``xattn``.  ``conv`` has none: decoding through its
    state is not ported."""
    check_block_kinds(mixer, "none")
    if mixer == "conv":
        raise NotImplementedError(_NO_CONV_DECODE)
    if mixer == "attn":
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros((batch,), dtype=torch.int32, device=device))
    if mixer == "mamba":
        shape = mamba_state_shape(cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                                  d_state=cfg.ssm_state_dim, batch=batch)
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if mixer == "mlstm":
        shape = mlstm_state_shape(cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                                  batch=batch)
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if mixer == "slstm":
        return slstm_state(batch, cfg.d_model, device)
    return None


def apply_block(
    p: dict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    kinds: tuple[str, str],
    positions: torch.Tensor,
    cache: Cache,
    mode: str,
    context: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Cache]:
    """One block (weights ``p``, (mixer, ffn) ``kinds``) over x (B, S, D).
    Returns (x, the block's new cache): prefill fills ``cache`` (the
    template) in place, decode updates it.  ``context`` (B, Nctx, D) is what
    ``xattn`` attends to.  ``attn_nc`` and ``xattn`` run in train mode with
    no cache in every mode (decode too), as in the reference."""
    mixer, ffn = kinds
    # the mixer's span: norm1, the mixer and its residual
    with obs.span("lm.attention" if mixer in _ATTENTION else "lm.mixer") as sp:
        x = sp.input(x)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        new_cache: Cache = None
        if mixer in _ATTENTION:
            causal = mixer == "attn"
            if mixer == "xattn" and context is None:
                raise ValueError("a cross-attention block needs a context")
            y, kvc = attention(
                p["mixer"], h, positions,
                causal=causal,
                impl=cfg.attention_impl,
                rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope and mixer != "xattn",  # the reference rotates no cross q
                kv_x=context if mixer == "xattn" else None,
                cache=cache if causal and mode == "decode" else None,
                mode=mode if causal else "train",
                block=cfg.attn_block,
                norm_eps=cfg.norm_eps,
            )
            if causal and mode == "decode":
                new_cache = kvc
            elif causal and mode == "prefill":
                new_cache = _fit_cache(kvc, cache)
        elif mixer == "conv":
            if mode == "decode":
                raise NotImplementedError(_NO_CONV_DECODE)
            with obs.span("lm.conv") as cs:
                y = cs.output(short_conv(p["mixer"], cs.input(h)))
        else:
            # decode is the sequential one-token update whatever the impl
            state = cache if mode == "decode" else None
            if mixer == "mamba":
                y, st = mamba(p["mixer"], h, chunk=cfg.ssm_chunk, state=state, mode=mode,
                              impl=cfg.ssm_impl if mode != "decode" else "chunked")
            elif mixer == "mlstm":
                y, st = mlstm(p["mixer"], h, chunk=cfg.ssm_chunk, state=state, mode=mode)
            else:
                y, st = slstm(p["mixer"], h, state=state, mode=mode)
            if mode in ("prefill", "decode"):
                new_cache = st
        x = sp.output(constrain(x + y, "batch", None, None))

    if ffn == "none":
        return x, new_cache
    with obs.span("lm.ffn") as sp:
        x = sp.input(x)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if ffn == "dense":
            y = mlp(p["ffn"], h)
        elif option(cfg, "router") == "sigmoid_bias":
            y = moe_mod.moe_routed(p["ffn"], h, top_k=cfg.experts_per_token,
                                   offset=option(cfg, "expert_offset"),
                                   scale=option(cfg, "routed_scaling_factor"))
        else:
            y = moe_mod.moe(
                p["ffn"], h,
                top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor,
                group_size=cfg.moe_group_size,
                dropless=(mode == "decode"),  # tiny token count: exact routing
            )
        x = sp.output(constrain(x + y, "batch", None, None))
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
