"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias  [hf:Qwen/Qwen2.5; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1e6,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2.5-32b-reduced", n_layers=2, d_model=80,
        n_heads=5, n_kv_heads=1, head_dim=16, d_ff=192, vocab=256)
