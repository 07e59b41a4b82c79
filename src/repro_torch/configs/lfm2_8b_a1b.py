"""LFM2-8B-A1B — gated short-conv and QK-norm GQA blocks, a dropless
sigmoid-routed 32-expert top-4 MoE [hf:LiquidAI/LFM2-8B-A1B].

24 layers: the gated short convolution (3 taps) everywhere but the six GQA
attention layers at 2, 6, 10, 14, 18 and 21; two dense SwiGLU layers
(d_ff 7,168), then MoE layers of 32 experts 1,792 wide, top-4, chosen by
sigmoid score + expert bias, the chosen scores renormalised.  A port-only
preset (``HybridConfig``): the reference has none.
"""
from repro_torch.configs.hybrid import HybridConfig

ATTENTION_LAYERS = (2, 6, 10, 14, 18, 21)
NUM_DENSE_LAYERS = 2

LAYERS = tuple(("attn" if i in ATTENTION_LAYERS else "conv",
                "dense" if i < NUM_DENSE_LAYERS else "moe") for i in range(24))

CONFIG = HybridConfig(
    name="lfm2-8b-a1b", family="hybrid", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=8, d_ff=7168, vocab_size=65536, pattern=LAYERS,
    num_experts=32, experts_per_token=4, moe_d_ff=1792, qk_norm=True, conv_kernel=3,
    router="sigmoid_bias", routed_scaling_factor=1.0, rope_theta=1e6, norm_eps=1e-5,
)
