"""Model/architecture configuration (the port's own copy of
``repro/configs/base.py``: the same fields, defaults and presets).

Each architecture is a ``ModelConfig`` preset in its own module
(``repro_torch/configs/<id>.py``) with the exact published dimensions, plus
``registry.smoke()``, a reduction of the same family for CPU tests.  The
layer stack is described as a *group pattern* — a fixed sequence of (mixer,
ffn) block types — repeated ``n_groups`` times; the port runs it as an
explicit loop over ``num_layers`` blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "attn_nc", "xattn", "mamba", "mlstm", "slstm"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # layer-stack pattern: list of (mixer, ffn); stack = pattern * n_groups
    pattern: tuple[tuple[Mixer, Ffn], ...] = (("attn", "dense"),)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024

    # SSM / xLSTM
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_state_dim: int = 128
    ssm_chunk: int = 256
    ssm_impl: str = "chunked"        # chunked (plain PyTorch) | pallas (the hand-written kernel)

    # encoder-decoder (audio) / cross-attention (vlm)
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30s of 10ms frames after conv
    num_context_tokens: int = 0      # vlm: image patch tokens (stub frontend)

    # attention details
    rope_theta: float = 10000.0
    use_rope: bool = True
    attention_impl: str = "chunked"  # naive | chunked | pallas
    attn_block: int = 512

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True

    # which shapes apply (capability flags for the cell matrix)
    supports_decode: bool = True
    subquadratic: bool = False       # can run long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )

    @property
    def n_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = v * d  # embedding (tied)
        per_layer = {}
        attn_p = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        dense_ffn = 3 * d * f
        moe_ffn = d * self.num_experts + 3 * self.num_experts * d * f
        d_inner = self.ssm_expand * d
        n_ssm_heads = d_inner // self.ssm_head_dim
        mamba_p = d * 2 * d_inner + d * 2 * self.ssm_state_dim + d * n_ssm_heads + d_inner * d + d_inner
        mlstm_p = 4 * d * d_inner + 2 * d * (d_inner // self.ssm_head_dim) + d_inner * d + d_inner
        slstm_p = 5 * d * d
        mixer_params = {"attn": attn_p, "attn_nc": attn_p, "xattn": attn_p,
                        "mamba": mamba_p, "mlstm": mlstm_p, "slstm": slstm_p}
        ffn_params = {"dense": dense_ffn, "moe": moe_ffn, "none": 0}
        total_per_group = sum(mixer_params[m] + ffn_params[fn] + 2 * d for m, fn in self.pattern)
        n += total_per_group * self.n_groups + d
        if self.is_encdec:
            n += self.encoder_layers * (attn_p + dense_ffn + 2 * d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive_per_moe = 3 * (self.num_experts - self.experts_per_token) * d * f
        n_moe_layers = sum(1 for _, fn in self.pattern if fn == "moe") * self.n_groups
        return self.param_count() - n_moe_layers * inactive_per_moe


# ---------------------------------------------------------------------------
# Input shapes (the assignment's per-arch shape set)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applies(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention — sub-quadratic required for 500k decode"
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture has no decode step"
    return True, ""
