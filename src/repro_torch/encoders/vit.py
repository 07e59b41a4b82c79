"""DINO-style ViT feature encoder (the paper's vision encoder), port of
``repro.encoders.vit``.

The paper uses DINO-ViT-B/16's final-layer CLS embedding as the frozen
feature representation.  The architecture is the reference's; pretrained
weights are a deployment artifact, so weights here are random
(``init_vit``) or carried from the reference (``params_from_jax``).
Attention is a plain ``matmul``/``softmax``, as the reference leaves it
to XLA, and GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense, init_dense, layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def init_layer(gen: torch.Generator, d_model: int, d_ff: int) -> dict[str, torch.Tensor]:
    """One pre-norm transformer layer (shared with the text encoder)."""
    dev = gen.device
    return {
        "ln1_s": torch.ones((d_model,), device=dev), "ln1_b": torch.zeros((d_model,), device=dev),
        "wqkv": init_dense(gen, d_model, 3 * d_model, torch.float32),
        "wo": init_dense(gen, d_model, d_model, torch.float32),
        "ln2_s": torch.ones((d_model,), device=dev), "ln2_b": torch.zeros((d_model,), device=dev),
        "w1": init_dense(gen, d_model, d_ff, torch.float32),
        "w2": init_dense(gen, d_ff, d_model, torch.float32),
    }


def init_vit(cfg: ViTConfig, *, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random f32 weights drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (the port's own draws: not the reference's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    return {
        "patch_proj": init_dense(gen, 3 * cfg.patch_size ** 2, d, torch.float32),
        "cls": torch.randn((1, 1, d), generator=gen, device=dev) * 0.02,
        "pos": torch.randn((1, cfg.n_patches + 1, d), generator=gen, device=dev) * 0.02,
        "layers": [init_layer(gen, d, cfg.d_ff) for _ in range(cfg.num_layers)],
        "ln_f_s": torch.ones((d,), device=dev), "ln_f_b": torch.zeros((d,), device=dev),
    }


def params_from_jax(params: dict, cfg, *, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_vit`` / ``init_text_encoder`` params (numpy
    arrays) as the port's: each per-layer leaf's leading ``num_layers``
    axis (``jax.vmap(init_layer)``) unstacked into a list of layers."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    out = {k: tensor(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: tensor(np.asarray(v)[i]) for k, v in params["layers"].items()}
                     for i in range(cfg.num_layers)]
    return out


def attention(lp: dict, x: torch.Tensor, n_heads: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain multi-head self-attention; keys where ``mask`` is not > 0 get
    the logit −1e30 (the reference's ``where``)."""
    b, s, d = x.shape
    qkv = dense(x, lp["wqkv"]).reshape(b, s, 3, n_heads, d // n_heads)
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / ((d // n_heads) ** 0.5)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, -1e30)
    a = torch.softmax(logits, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, s, d)
    return dense(out, lp["wo"])


def layer(lp: dict, x: torch.Tensor, n_heads: int,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-norm block: attention, then the tanh-GELU MLP, each residual."""
    x = x + attention(lp, layer_norm(x, lp["ln1_s"], lp["ln1_b"]), n_heads, mask)
    h = layer_norm(x, lp["ln2_s"], lp["ln2_b"])
    return x + dense(F.gelu(dense(h, lp["w1"]), approximate="tanh"), lp["w2"])


@torch.no_grad()
def vit_encode(params: dict, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """images: (B, H, W, 3) float -> (B, d_model) CLS embeddings."""
    b = images.shape[0]
    p = cfg.patch_size
    n = cfg.image_size // p
    patches = images.reshape(b, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, -1)
    x = dense(patches, params["patch_proj"])
    x = torch.cat([params["cls"].expand(b, 1, cfg.d_model), x], dim=1)
    x = x + params["pos"]
    for lp in params["layers"]:
        x = layer(lp, x, cfg.num_heads)
    x = layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x[:, 0]  # CLS
