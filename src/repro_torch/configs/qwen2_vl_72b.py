"""qwen2-vl-72b [vlm]: qwen2-72b backbone + M-RoPE (t/h/w rotary sections)
+ dynamic-resolution vision frontend as a STUB — input_specs() provides
patch embeddings and (t, h, w) position ids  [arXiv:2409.12191; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab=256,
        mrope_sections=(4, 2, 2))
