"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    pattern=(("attn", "moe"),), num_experts=32, experts_per_token=8,
    # §Perf iter-7: dispatch one-hot traffic scales with group_size*k*cf;
    # 256 keeps expert tiles MXU-viable (cap=80) while cutting dispatch 4x.
    moe_group_size=256,
)
