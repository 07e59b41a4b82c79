"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0 per the assignment sheet: projections live inside the recurrent
blocks.  sLSTM at every 6th position (5 mLSTM : 1 sLSTM).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", num_layers=12, d_model=768, num_heads=4,
    num_kv_heads=4, d_ff=0, vocab_size=50304,
    pattern=(("mlstm", "none"),) * 5 + (("slstm", "none"),),
    ssm_expand=2, ssm_head_dim=192, subquadratic=True, use_rope=False,
)
