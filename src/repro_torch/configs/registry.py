"""Architecture registry: ``--arch <id>`` resolution for launchers/tests.

``ARCHS`` holds the reference's presets, one for one; ``PORT_ONLY`` the
port's own (``HybridConfig`` presets the reference has none of).  ``get``
and ``smoke`` resolve both."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    granite_moe,
    internlm2_1_8b,
    jamba_1_5_large,
    lfm2_8b_a1b,
    llama32_vision_90b,
    phi35_moe,
    stablelm_12b,
    whisper_small,
    xlstm_125m,
    yi_6b,
    yi_9b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applies
from repro_torch.configs.hybrid import HybridConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in [
        yi_6b, internlm2_1_8b, stablelm_12b, yi_9b, whisper_small, xlstm_125m,
        llama32_vision_90b, phi35_moe, granite_moe, jamba_1_5_large,
    ]
}

PORT_ONLY: dict[str, ModelConfig] = {lfm2_8b_a1b.CONFIG.name: lfm2_8b_a1b.CONFIG}


def get(name: str) -> ModelConfig:
    cfg = ARCHS.get(name) or PORT_ONLY.get(name)
    if cfg is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(PORT_ONLY)}")
    return cfg


def smoke(cfg: ModelConfig | str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if isinstance(cfg, str):
        cfg = get(cfg)
    extra = {}
    if isinstance(cfg, HybridConfig):   # every expert held, at a smoke width
        extra = dict(moe_d_ff=96 if cfg.num_experts else 0, experts_held=0, expert_offset=0)
    return dataclasses.replace(
        cfg,
        **extra,
        num_layers=len(cfg.pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_group_size=64,
        capacity_factor=8.0,  # no-drop at smoke scale: decode == train exactly
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_state_dim=16,
        ssm_chunk=16,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=24 if cfg.encoder_layers else cfg.encoder_seq,
        num_context_tokens=8 if cfg.num_context_tokens else 0,
        attn_block=32,
        attention_impl="naive",
        remat=False,
    )


def all_cells() -> list[tuple[str, str, bool, str]]:
    """Every (arch, shape) cell with its applicability verdict."""
    out = []
    for aname, cfg in ARCHS.items():
        for sname, shp in SHAPES.items():
            ok, why = shape_applies(cfg, shp)
            out.append((aname, sname, ok, why))
    return out
