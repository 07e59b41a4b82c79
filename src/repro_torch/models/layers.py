"""Primitive layers: norms, dense, embedding, rotary embedding.

The port of ``repro/models/layers.py``.  Weight layouts are the reference's
(``(d_in, d_out)`` for a dense weight, ``(vocab, d_model)`` for the table),
so weights carry over from the reference one for one.  A bf16 matrix
product here accumulates in f32 and rounds its output once to bf16 — the
reference's ``preferred_element_type`` contract — in one PyTorch call.

``rms_norm`` and ``unembed`` carry the reference's custom VJPs as
``torch.autograd.Function``s: RMSNorm saves only its storage-dtype input and
recomputes the f32 statistics in backward; the unembedding casts its
cotangent to the storage dtype before both backward products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import lookup_rows


def _rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``_rms_norm_fwd`` / ``_rms_norm_bwd``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + ctx.eps)
        xhat = x32 * inv
        gs = g32 * scale.float()
        dx = inv * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
        dscale = torch.sum((g32 * xhat).reshape(-1, x.shape[-1]), dim=0).to(scale.dtype)
        return dx.to(x.dtype), dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics and storage-dtype I/O."""
    return _RMSNorm.apply(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics (``var = mean((x − mu)²)``) and the
    result in ``x``'s dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """Normal weights scaled by ``sqrt(2 / (d_in + d_out))``, drawn in f32
    from ``gen`` (on ``gen``'s device unless ``device`` says otherwise)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=device or gen.device)
    return (w * scale).to(dtype)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.bfloat16,
                   device=None) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, device=device or gen.device)
    return (w * 0.02).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table looks its rows up on each rank's
    shard (``sharding.lookup_rows``)."""
    if isinstance(table, DTensor):
        return lookup_rows(table, tokens)
    return table[tokens]


class _Unembed(torch.autograd.Function):
    """The reference's ``_unembed_fwd`` / ``_unembed_bwd``: the cotangent in
    the storage dtype, f32 accumulation inside both products."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        return x @ table.to(x.dtype).T

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = (g @ table.to(x.dtype)).to(x.dtype)
        dtable = (g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])).to(table.dtype)
        return dx, dtable


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied unembedding ``(..., D) @ (V, D)ᵀ -> (..., V)``: f32 accumulation,
    logits in the activation dtype."""
    return _Unembed.apply(x, table)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # a Python scalar base: a tensor made from it on the card would be a
    # host-to-device copy, which waits for the stream, in every layer
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding in f32, cast back to ``x``'s dtype.

    x: (..., S, H, D) with D even; positions: (..., S) integer absolute
    positions (broadcastable).
    """
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs                    # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(x, w_gate)) * dense(x, w_up)
    return h.to(x.dtype) @ w_down


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.bfloat16) -> dict:
    return {
        "w_gate": init_dense(gen, d_model, d_ff, dtype),
        "w_up": init_dense(gen, d_model, d_ff, dtype),
        "w_down": init_dense(gen, d_ff, d_model, dtype),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
