"""Blocks and the layer stack of the port's LM substrate: the reference's
``repro/models/transformer.py``.

One ``Block`` module per kind, with the reference's parameter keys:

    dense / vlm — GQA attention + SwiGLU MLP      (qwen2, stablelm, internlm2,
                                                   qwen2-vl)
    moe         — GQA (grok) or MLA (deepseek) attention + MoE FFN
    ssm         — Mamba-1 mixer only               (falcon-mamba)
    hybrid      — parallel attention / SSM heads + MLP (hymba)
    enc         — bidirectional attention + MLP    (the whisper encoder)
    dec         — causal attention + cross-attention (``ln_x``, ``xattn``)
                  + MLP                            (the whisper decoder)

The reference scans the layers over stacked parameters; here the stack is
a Python loop over an ``nn.ModuleList``.  Its training path (no caches,
autograd recording, ``cfg.remat != "none"``) runs the layers in groups,
each under ``torch.utils.checkpoint`` (the reference's ``_remat_group`` and
``_remat_policy``): ``"full"`` saves nothing inside a group, ``"dots"``
saves the matrix products without a batch dimension (the outputs of
``aten.mm`` / ``aten.addmm``, the counterpart of JAX's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest.  Caches
keep the reference's layout: one tensor per leaf with a leading layer axis.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel import ctx
from . import layers as Ly
from .config import ModelConfig

KINDS = ("dense", "vlm", "moe", "ssm", "hybrid", "enc", "dec")
# kinds whose cache is a full KV cache (or MLA's latent) that attention
# writes in place at ``cache_index`` (the others' caches are stacked anew)
FULL_CACHE_KINDS = ("dense", "vlm", "moe", "dec")


class Block(nn.Module):
    """The parameters of one layer of ``kind`` (kept as ``self.kind``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; known: {KINDS}")
        self.kind = kind
        d = cfg.d_model
        self.ln1 = Ly.RMSNorm(d, device)
        if kind == "ssm":
            self.mamba = Ly.Mamba(cfg, device)
            return
        self.attn = (Ly.MLA(cfg, device) if kind == "moe" and cfg.use_mla
                     else Ly.Attention(cfg, device))
        if kind == "hybrid":
            self.mamba = Ly.Mamba(cfg, device)
            self.attn_norm = Ly.RMSNorm(d, device)
            self.ssm_norm = Ly.RMSNorm(d, device)
        if kind == "dec":
            self.ln_x = Ly.RMSNorm(d, device)
            self.xattn = Ly.Attention(cfg, device)
        self.ln2 = Ly.RMSNorm(d, device)
        if kind == "moe":
            self.moe = Ly.MoE(cfg, device)
        else:
            self.mlp = Ly.MLP(cfg, device)

    reset = Ly.reset_children


def block_apply(p: Block, cfg: ModelConfig, x, positions, kv_cache=None,
                cache_index: Optional[int] = None, enc_out=None):
    """One block of kind ``p.kind``; returns (x, new_cache, aux) with aux
    the MoE load-balancing loss (a float 0.0 for the other kinds, which
    launches nothing).

    * ``ssm``: a scan from a zero state, or from ``kv_cache`` = (conv,
      h); the cache is (new conv, h_T).
    * ``hybrid``: prefill (``cache_index`` None) runs windowed attention
      over the sequence and returns its (k, v); decode runs rolling-cache
      attention at position ``cache_index``.  The SSM heads as ``ssm``.
    * the others: causal attention (``enc``: mask ``none``, no cache),
      written into and attending over the full ``kv_cache`` (k, v) — or
      MLA's latent — at ``cache_index`` (see ``layers.attention_apply``);
      ``dec`` then cross-attends to ``enc_out`` (mask ``none``)."""
    kind = p.kind
    aux = 0.0
    new_cache = None
    h = Ly.rmsnorm(p.ln1, x)

    if kind == "ssm":
        y, new_cache = Ly.mamba_apply(p.mamba, cfg, h, state=kv_cache)
        return x + y, new_cache, aux

    if kind == "hybrid":
        a_cache = None if kv_cache is None else kv_cache[0]
        m_state = None if kv_cache is None else kv_cache[1]
        if cache_index is not None:          # decode: O(window) rolling cache
            attn_out, a_new = Ly.attention_decode_rolling(
                p.attn, cfg, h, cache_index, a_cache)
        else:
            attn_out, a_new = Ly.attention_apply(
                p.attn, cfg, h, positions, mask_kind="window",
                window=cfg.window)
        ssm_out, m_new = Ly.mamba_apply(p.mamba, cfg, h, state=m_state)
        # Hymba: fuse the two heads' outputs after per-branch normalization
        y = 0.5 * Ly.rmsnorm(p.attn_norm, attn_out) \
            + 0.5 * Ly.rmsnorm(p.ssm_norm, ssm_out)
        x = x + y
        x = x + Ly.mlp_apply(p.mlp, Ly.rmsnorm(p.ln2, x))
        return x, (a_new, m_new), aux

    if kind == "moe" and cfg.use_mla:
        y, new_cache = Ly.mla_apply(p.attn, cfg, h, positions,
                                    kv_cache=kv_cache,
                                    cache_index=cache_index)
    elif kind == "enc":
        y, _ = Ly.attention_apply(p.attn, cfg, h, positions,
                                  mask_kind="none")
    else:
        y, new_cache = Ly.attention_apply(
            p.attn, cfg, h, positions, mask_kind="causal",
            kv_cache=kv_cache, cache_index=cache_index)
    x = x + y

    if kind == "dec":
        hx = Ly.rmsnorm(p.ln_x, x)
        B, Se = enc_out.shape[:2]
        enc_pos = torch.arange(Se, device=x.device)[None].expand(B, Se)
        y, _ = Ly.attention_apply(p.xattn, cfg, hx, positions, kv_x=enc_out,
                                  kv_positions=enc_pos, mask_kind="none")
        x = x + y

    h2 = Ly.rmsnorm(p.ln2, x)
    if kind == "moe":
        y, aux = Ly.moe_apply(p.moe, cfg, h2)
    else:
        y = Ly.mlp_apply(p.mlp, h2)
    return x + y, new_cache, aux


def tree_map(fn, tree):
    """``fn`` over the tensors of a cache of nested tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tuple(tree_map(fn, t) for t in tree)


def tree_leaves(tree) -> list:
    """The tensors of a cache in the reference's leaf order (dict keys
    sorted, as ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [x for t in tree for x in tree_leaves(t)]


def _stack(trees):
    """Stack per-layer caches of one structure on a leading layer axis."""
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return tuple(_stack([t[j] for t in trees]) for j in range(len(trees[0])))


def remat_group(L: int) -> int:
    """Largest divisor of L <= ceil(sqrt(L)): the layers of one checkpoint
    group (L / G group boundaries are kept instead of L)."""
    g = max(int(math.ceil(math.sqrt(L))), 1)
    while g > 1 and L % g != 0:
        g -= 1
    return g


# the matrix products without a batch dimension: a dense layer's x @ w
MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _group_apply(blocks, cfg: ModelConfig, x, positions, enc_out):
    """Layers ``blocks`` in order, without caches: (x, aux)."""
    aux = 0.0
    for p in blocks:
        x = ctx.shard(x, ("batch", "seq", None))
        x, _, a = block_apply(p, cfg, x, positions, enc_out=enc_out)
        aux = aux + a
    return x, aux


def _remat_apply(blocks: nn.ModuleList, cfg: ModelConfig, x, positions,
                 enc_out):
    """The training path: the layers in groups of ``cfg.remat_group`` (or
    ``remat_group(L)``), each group under ``checkpoint`` with the policy of
    ``cfg.remat``."""
    L = len(blocks)
    G = (cfg.remat_group if cfg.remat_group and L % cfg.remat_group == 0
         else remat_group(L))
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    aux = 0.0
    for g0 in range(0, L, G):
        x, a = checkpoint(_group_apply, blocks[g0:g0 + G], cfg, x, positions,
                          enc_out, use_reentrant=False, **kw)
        aux = aux + a
    return x, aux


def stack_apply(blocks: nn.ModuleList, cfg: ModelConfig, x, positions,
                caches=None, cache_index: Optional[int] = None,
                enc_out=None, collect_caches: bool = False):
    """Apply the layers in order; returns (x, new_caches, aux summed over
    the layers).  ``caches`` carries a leading layer axis.  A full KV
    cache (or MLA's latent) with ``cache_index`` is written IN PLACE, each
    layer into its slice, and returned; any other cache (SSM states,
    Hymba's rolling window) is read, and a new one stacked from the
    layers' returns.  Without ``caches``, ``collect_caches`` stacks the
    layers' own caches (hybrid prefill builds its rolling cache from
    them), else the new caches are None.  Without caches, when autograd
    records and ``cfg.remat`` is not ``"none"``, the layers run in
    checkpointed groups (``_remat_apply``)."""
    if (caches is None and not collect_caches and cfg.remat != "none"
            and torch.is_grad_enabled()):
        x, aux = _remat_apply(blocks, cfg, x, positions, enc_out)
        return x, None, aux
    in_place = (caches is not None and cache_index is not None
                and blocks[0].kind in FULL_CACHE_KINDS)
    collected = []
    aux = 0.0
    for i, p in enumerate(blocks):
        c = None if caches is None else tree_map(lambda t: t[i], caches)
        x = ctx.shard(x, ("batch", "seq", None))
        x, c_new, a = block_apply(p, cfg, x, positions, kv_cache=c,
                                  cache_index=cache_index, enc_out=enc_out)
        aux = aux + a
        if not in_place and (caches is not None or collect_caches):
            collected.append(c_new)
    if in_place:
        return x, caches, aux
    return x, (_stack(collected) if collected else None), aux
