"""stablelm-1.6b [dense]: 24L d_model=2048 32H (kv=32) d_ff=5632
vocab=100352  [hf:stabilityai/stablelm-2-1_6b; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab=256)
