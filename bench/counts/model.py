"""Model FLOPs of a dense decoder's training step, in PaLM's form
(Chowdhery et al., 2022, App. B): 6·N per token for the matmul weights N
(the output head included) plus 12·n_layers·d_model·seq_len per token for
attention's two products, forward and backward, with no credit for
recomputation."""
from __future__ import annotations


def matmul_params(model: dict) -> int:
    """Weights that enter a matmul: every layer's q, k, v, o and SwiGLU
    projections, and the output head (one vocab × d matrix, whether or not
    it is tied to the embedding, which is looked up, not multiplied)."""
    d, f, v = model["hidden_size"], model["intermediate_size"], model["vocab_size"]
    h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // h
    per_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f
    return model["num_hidden_layers"] * per_layer + v * d


def train_flops_per_token(model: dict, seq_len: int) -> float:
    return 6.0 * matmul_params(model) + 12.0 * model["num_hidden_layers"] * model["hidden_size"] * seq_len


def train_flops_per_step(model: dict, batch: int, seq_len: int) -> float:
    return train_flops_per_token(model, seq_len) * batch * seq_len
