"""whisper-tiny [audio]: 4+4L d_model=384 6H d_ff=1536 vocab=51865,
enc-dec; the conv frontend is a STUB — input_specs() provides post-conv
frame embeddings (B, 1500, d)  [arXiv:2212.04356; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, enc_positions=1500,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-reduced", n_layers=2, enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=256, enc_positions=32)
