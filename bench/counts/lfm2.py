"""Model FLOPs of LFM2-8B-A1B's training step at one expert-parallel rank's
share, in PaLM's form (``bench/counts/model.py``): 6·N per token for the
matmul weights a token meets, the held experts at their expected share of
its choices (k · held / routed experts of one expert's weights), plus
12·n_attention_layers·d_model·seq_len per token for attention's two
products; no credit for recomputation.  The conv layers' 3-tap
convolutions and the gating are elementwise work, not counted."""
from __future__ import annotations


def _attention_layers(model: dict) -> int:
    return sum(t == "full_attention" for t in model["layer_types"])


def matmul_params(model: dict) -> float:
    """Weights a token meets in a matmul: each conv layer's in_proj and
    out_proj, each attention layer's q, k, v, o, the dense SwiGLUs, each MoE
    layer's router and its expected share of one expert, and the head."""
    d, v = model["hidden_size"], model["vocab_size"]
    f, fe = model["intermediate_size"], model["moe_intermediate_size"]
    h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd, e = d // h, model["router_experts"]
    n_attn = _attention_layers(model)
    n_conv = model["num_hidden_layers"] - n_attn
    n_dense = model["num_dense_layers"]
    n_moe = model["num_hidden_layers"] - n_dense
    expert_share = model["num_experts_per_tok"] * model["num_experts"] / e
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    return (n_conv * 4 * d * d + n_attn * attn + n_dense * 3 * d * f
            + n_moe * (d * e + expert_share * 3 * d * fe) + v * d)


def train_flops_per_token(model: dict, seq_len: int) -> float:
    return (6.0 * matmul_params(model)
            + 12.0 * _attention_layers(model) * model["hidden_size"] * seq_len)


def train_flops_per_step(model: dict, batch: int, seq_len: int) -> float:
    return train_flops_per_token(model, seq_len) * batch * seq_len


def expert_flops_per_row(model: dict) -> float:
    """One held expert row's SwiGLU, forward and backward: three products of
    2·d·f_e FLOP, each run once forward and twice backward (18·d·f_e)."""
    return 18.0 * model["hidden_size"] * model["moe_intermediate_size"]
