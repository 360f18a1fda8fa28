"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
ssm_state=16, parallel attention+mamba heads, sliding-window attention
(w=1024) + 128 meta tokens  [arXiv:2411.13676; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, ssm_state=16, ssm_conv=4, ssm_expand=2,
    window=1024, meta_tokens=128,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hymba-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, window=32,
        meta_tokens=8, ssm_state=8)
