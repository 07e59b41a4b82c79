"""stablelm-12b — GQA dense [hf:stabilityai]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", num_layers=40, d_model=5120,
    num_heads=32, num_kv_heads=8, d_ff=13824, vocab_size=100352,
)
