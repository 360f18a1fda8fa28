"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA kv_lora=512) vocab=102400,
MoE 160 routed top-6 + 2 shared, expert d_ff=1536  [arXiv:2405.04434; hf].

All 60 layers are MoE with the assigned expert width (we do not add
DeepSeek's first-k-dense exception; the config is kept exactly as assigned —
DESIGN.md Sec. 4)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, head_dim=128,
    n_experts=160, top_k=6, n_shared_experts=2, expert_ff=1536,
    use_mla=True, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, vocab=256,
        n_experts=8, top_k=2, n_shared_experts=1, expert_ff=32, d_ff=32,
        kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16)
