"""``HybridConfig``: the port's own extension of ``ModelConfig`` for layer
kinds the reference has no preset of (``ModelConfig`` itself keeps the
reference's fields, so every reference preset still builds from it).

It adds:

- the ``conv`` mixer (a gated causal depthwise short convolution of
  ``conv_kernel`` taps, LFM2's), beside ``attn``;
- per-head RMSNorm on the queries and the keys before the rotary embedding
  (``qk_norm``);
- a second FFN width for the experts (``moe_d_ff``; ``d_ff`` stays the
  dense FFN's);
- the ``sigmoid_bias`` router: sigmoid scores, experts chosen by the top-k
  of score + ``expert_bias`` (a buffer the train step reads and never
  updates), the chosen scores renormalised and scaled by
  ``routed_scaling_factor``, run by the dropless route of ``models/moe.py``
  (the ``softmax`` router keeps the capacity route);
- the share of the experts held here (``experts_held`` from
  ``expert_offset``; 0 holds them all): an expert-parallel rank's experts,
  whose layer output is this rank's part of the sum over ranks.

An irregular layer list is a ``pattern`` as long as the stack
(``n_groups`` 1).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.configs.base import ModelConfig

Router = Literal["softmax", "sigmoid_bias"]


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    moe_d_ff: int = 0                # 0 -> d_ff
    qk_norm: bool = False
    conv_kernel: int = 3
    router: Router = "softmax"
    routed_scaling_factor: float = 1.0
    experts_held: int = 0            # 0 -> every expert
    expert_offset: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.num_experts and not (
                0 <= self.expert_offset
                and self.expert_offset + self.n_held <= self.num_experts):
            raise ValueError(f"{self.name}: experts {self.expert_offset}.."
                             f"{self.expert_offset + self.n_held - 1} held of {self.num_experts}")

    @property
    def n_held(self) -> int:
        """How many experts of each MoE layer this rank holds."""
        return self.experts_held or self.num_experts

    def _counts(self) -> dict[str, int]:
        d, hd = self.d_model, self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.qk_norm:
            attn += 2 * hd
        conv = d * 3 * d + d * self.conv_kernel + d * d
        expert = 3 * d * self.moe_d_ff
        return {"attn": attn, "conv": conv, "dense": 3 * d * self.d_ff, "expert": expert,
                "router": d * self.num_experts, "norm": d}

    def _total(self, experts_per_moe_layer: int) -> int:
        c = self._counts()
        n = self.vocab_size * self.d_model + c["norm"]       # tied embedding, final norm
        for mixer, ffn in list(self.pattern) * self.n_groups:
            n += c[mixer] + c["norm"]
            if ffn == "dense":
                n += c["dense"] + c["norm"]
            elif ffn == "moe":
                n += c["router"] + experts_per_moe_layer * c["expert"] + c["norm"]
        return n

    def param_count(self) -> int:
        """Parameters held here: every layer's mixer (conv, or attention with
        its q/k norm scales), the dense FFNs at ``d_ff``, each MoE layer's
        whole router and its held experts at ``moe_d_ff``, the norms and
        the tied embedding (``expert_bias`` is a buffer, not counted)."""
        return self._total(self.n_held)

    def active_param_count(self) -> int:
        """Parameters a token touches: ``experts_per_token`` experts of each
        MoE layer, wherever they are held."""
        if self.num_experts == 0:
            return self._total(0)
        return self._total(self.experts_per_token)


def option(cfg: ModelConfig, name: str):
    """A ``HybridConfig`` field of ``cfg``, or its default for a plain
    ``ModelConfig`` (which runs none of these kinds)."""
    if isinstance(cfg, HybridConfig):
        return getattr(cfg, name)
    if name == "moe_d_ff":
        return cfg.d_ff
    if name == "n_held":
        return cfg.num_experts
    return {f.name: f.default for f in dataclasses.fields(HybridConfig)}[name]
