"""llama-3.2-vision-90b — cross-attn image layers [hf:meta-llama].

100 decoder layers; gated cross-attention to image patch embeddings every
5th layer.  Patch frontend stubbed: input_specs() supplies embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", num_layers=100, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    pattern=(("attn", "dense"),) * 4 + (("xattn", "dense"),),
    num_context_tokens=1601, rope_theta=500000.0,
)
