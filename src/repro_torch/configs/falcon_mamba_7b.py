"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free mamba1
(d_inner=8192, d_state=16, d_conv=4), vocab=65024
[arXiv:2410.05355; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, ssm_state=16, ssm_conv=4, ssm_expand=2,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="falcon-mamba-reduced", n_layers=2, d_model=64,
        vocab=256, ssm_state=8)
