"""jamba-1.5-large-398b — Mamba+attn 1:7, MoE 16e top-2 [arXiv:2403.19887].

Attention every 8th layer; MoE every other layer; Mamba carries the long
context, so long_500k decode runs (subquadratic=True).
"""
from repro_torch.configs.base import ModelConfig

_GROUP = (
    ("attn", "moe"), ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
    ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", num_layers=72, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=24576, vocab_size=65536,
    pattern=_GROUP, num_experts=16, experts_per_token=2, subquadratic=True,
)
