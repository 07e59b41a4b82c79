"""Sentence-transformer-style text encoder (paper: all-distilroberta-v1),
port of ``repro.encoders.text``.

Mean-pooled final-layer token embeddings, as in SBERT — the paper's text
feature representation.  Weights are random (``init_text_encoder``) or
carried from the reference (``params_from_jax``).  Token ids must lie in
``[0, vocab_size)``: torch's indexing raises where ``jnp.take`` fills.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.encoders.vit import init_layer, layer, params_from_jax
from repro_torch.models.layers import init_embedding, layer_norm

__all__ = ["TextEncoderConfig", "init_text_encoder", "params_from_jax", "text_encode"]


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 50265
    max_len: int = 512
    d_model: int = 768
    num_layers: int = 6      # distilroberta
    num_heads: int = 12
    d_ff: int = 3072


def init_text_encoder(cfg: TextEncoderConfig, *, seed: int = 0,
                      device: str | torch.device = "cuda") -> dict:
    """Random f32 weights drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    return {
        "tok": init_embedding(gen, cfg.vocab_size, d, torch.float32),
        "pos": torch.randn((1, cfg.max_len, d), generator=gen, device=dev) * 0.02,
        "layers": [init_layer(gen, d, cfg.d_ff) for _ in range(cfg.num_layers)],
        "ln_f_s": torch.ones((d,), device=dev), "ln_f_b": torch.zeros((d,), device=dev),
    }


@torch.no_grad()
def text_encode(params: dict, tokens: torch.Tensor, cfg: TextEncoderConfig,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (B, S) integer -> (B, d_model) mean-pooled embeddings."""
    b, s = tokens.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    x = params["tok"][tokens] + params["pos"][:, :s]
    for lp in params["layers"]:
        x = layer(lp, x, cfg.num_heads, mask)
    x = layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    return (x * mask[..., None]).sum(1) / denom  # SBERT mean pooling
