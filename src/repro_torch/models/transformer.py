"""Block and layer stack of the port's LM substrate: the ``hybrid`` (Hymba)
branch of the reference's ``repro/models/transformer.py``.

A hybrid block runs sliding-window attention and a Mamba-1 mixer in
parallel on the same normalized input, fuses the two after per-branch
RMS normalisation, then applies a SwiGLU MLP.  The reference scans the
layers over stacked parameters with rematerialization; serving has no
backward, so here the stack is a Python loop over an ``nn.ModuleList``.
Caches keep the reference's layout: one tensor per leaf with a leading
layer axis.  ``build_model`` refuses the other families, so every block
here is a hybrid block.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import layers as Ly
from .config import ModelConfig


class HybridBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Ly.RMSNorm(d, device)
        self.attn = Ly.Attention(cfg, device)
        self.mamba = Ly.Mamba(cfg, device)
        self.attn_norm = Ly.RMSNorm(d, device)
        self.ssm_norm = Ly.RMSNorm(d, device)
        self.ln2 = Ly.RMSNorm(d, device)
        self.mlp = Ly.MLP(cfg, device)

    def reset(self, gen: torch.Generator):
        for m in (self.ln1, self.attn, self.mamba, self.attn_norm,
                  self.ssm_norm, self.ln2, self.mlp):
            m.reset(gen)


def block_apply(p: HybridBlock, cfg: ModelConfig, x, positions,
                kv_cache=None, cache_index: Optional[int] = None):
    """One block.  Prefill (``cache_index`` None): windowed attention over
    the whole sequence and a Mamba scan from a zero state (or from
    ``kv_cache[1]``).  Decode (``cache_index`` the token's absolute
    position): rolling-cache attention and a one-step scan from the
    carried state.  Returns (x, ((k, v) | (k, v, kpos), (conv, h_T)))."""
    h = Ly.rmsnorm(p.ln1, x)
    a_cache = None if kv_cache is None else kv_cache[0]
    m_state = None if kv_cache is None else kv_cache[1]
    if cache_index is not None:
        attn_out, a_new = Ly.attention_decode_rolling(
            p.attn, cfg, h, cache_index, a_cache)
    else:
        attn_out, a_new = Ly.attention_apply(p.attn, cfg, h, positions)
    ssm_out, m_new = Ly.mamba_apply(p.mamba, cfg, h, state=m_state)
    # Hymba: fuse the two heads' outputs after per-branch normalization
    y = 0.5 * Ly.rmsnorm(p.attn_norm, attn_out) \
        + 0.5 * Ly.rmsnorm(p.ssm_norm, ssm_out)
    x = x + y
    x = x + Ly.mlp_apply(p.mlp, Ly.rmsnorm(p.ln2, x))
    return x, (a_new, m_new)


def _index(tree, i: int):
    """Layer ``i`` of a cache whose leaves carry a leading layer axis."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tuple(_index(t, i) for t in tree)


def _stack(trees):
    """Stack per-layer caches of one structure on a leading layer axis."""
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return tuple(_stack([t[j] for t in trees]) for j in range(len(trees[0])))


def stack_apply(blocks: nn.ModuleList, cfg: ModelConfig, x, positions,
                caches=None, cache_index: Optional[int] = None,
                collect_caches: bool = False):
    """Apply the layers in order.  ``caches`` carries a leading layer axis;
    the new caches are returned stacked the same way when ``caches`` is
    given or ``collect_caches`` is set (hybrid prefill builds its rolling
    cache from them), else None.  Returns (x, new_caches)."""
    new = []
    for i, p in enumerate(blocks):
        c = None if caches is None else _index(caches, i)
        x, c_new = block_apply(p, cfg, x, positions, kv_cache=c,
                               cache_index=cache_index)
        if caches is not None or collect_caches:
            new.append(c_new)
    return x, (_stack(new) if new else None)
