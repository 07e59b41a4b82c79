"""whisper-small — enc-dec audio; conv frontend stubbed [arXiv:2212.04356].

12 encoder layers over precomputed frame embeddings; 12 decoder layers, each
a (self-attn, cross-attn) pair in the group pattern.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", num_layers=24, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    pattern=(("attn", "dense"), ("xattn", "dense")),
    encoder_layers=12, encoder_seq=1500, use_rope=False,
)
