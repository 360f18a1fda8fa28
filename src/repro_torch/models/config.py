"""Model configuration of the port's LM substrate: the reference's
``repro/models/config.py`` records (``ModelConfig``, ``ShapeConfig``,
``SHAPES``), kept as the port's own copy.  ``ParallelConfig`` is not
ported yet (it waits for the parallel layer)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_ff: int = 0             # per-expert hidden (MoE d_ff)
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"       # einsum | gather
    moe_groups: int = 1            # group-local dispatch

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0          # compressed KV dim
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- SSM (Mamba-1) --------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- hybrid (Hymba) --------------------------------------------------------
    window: int = 0                # sliding-window size (0 = full attention)
    meta_tokens: int = 0

    # --- encoder-decoder (Whisper) ---------------------------------------------
    enc_layers: int = 0
    enc_positions: int = 1500      # post-conv audio frames

    # --- VLM (Qwen2-VL) -----------------------------------------------------------
    mrope_sections: Tuple[int, ...] = ()   # (t, h, w) rotary sections

    # --- numerics / training -----------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "dots"            # none | dots | full
    remat_group: int = 0           # layers per checkpoint group (0 = sqrt(L))
    logical_rules: str = "default"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the padding ids are
        masked at the logits; ``param_count()`` uses the true vocab)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the 524k-token cell?"""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head), analytic."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = 0
        if self.family != "ssm":
            hd = self.head_dim
            if self.use_mla:
                q = d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                kv = (d * (self.kv_lora_rank + self.qk_rope_dim)
                      + self.kv_lora_rank * self.n_heads
                      * (self.qk_nope_dim + self.v_head_dim))
                o = self.n_heads * self.v_head_dim * d
                per += q + kv + o
            else:
                per += d * (self.n_heads + 2 * self.n_kv_heads) * hd
                per += self.n_heads * hd * d
        if self.family in ("ssm", "hybrid"):
            di, ds = self.d_inner, self.ssm_state
            per += d * 2 * di + di * self.ssm_conv + di * (2 * ds + 1) \
                + di * ds + di + di * d
        if self.n_experts > 0:
            per += d * self.n_experts          # router
            per += 3 * d * self.expert_ff * (self.n_experts
                                             + self.n_shared_experts)
        elif self.family != "ssm":
            per += 3 * d * self.d_ff
        per += 2 * d                            # norms
        total = emb + L * per
        if self.enc_layers:
            enc_per = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                + self.n_heads * self.head_dim * d + 3 * d * self.d_ff + 2 * d
            # decoder cross-attention
            total += self.enc_layers * enc_per + L * enc_per // 2
        return int(total)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        inactive = 3 * d * self.expert_ff * (self.n_experts - self.top_k)
        return int(self.param_count() - L * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the assigned shape grid)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
