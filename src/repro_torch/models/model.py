"""Model assembly of the port's LM substrate: ``build_model(cfg)`` ->
init / forward / init_cache / prefill / decode_step, the serving surface of
the reference's ``repro/models/model.py`` for the ``hybrid`` (Hymba)
family.

As in the reference the functions take the parameters and caches
explicitly: ``params`` is the ``HybridLM`` module that ``init`` returns (or
that ``convert.lm_params_from_reference`` fills from reference weights),
and a cache is the reference's nested tuple of tensors with a leading
layer axis.  Prefill runs the flash-attention kernel once per layer and
the Mamba scan once per layer; each decode step runs the scan once per
layer.  ``loss`` and training are not ported yet, nor any family but
``hybrid``: ``build_model`` raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from .. import runtime
from . import layers as Ly
from . import transformer as Tr
from .config import ModelConfig

PORTED_FAMILIES = ("hybrid",)


class HybridLM(nn.Module):
    """The parameters of a decoder LM, named as the reference's pytree:
    ``embed`` (padded_vocab, d), ``final_norm``, ``lm_head`` (unless
    tied), ``blocks`` (one module per layer) and ``meta`` (meta_tokens, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.embed = Ly.new_param((cfg.padded_vocab, d), device)
        self.final_norm = Ly.RMSNorm(d, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Ly.Dense(d, cfg.padded_vocab, device=device))
        self.blocks = nn.ModuleList(Tr.HybridBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.meta = (Ly.new_param((cfg.meta_tokens, d), device)
                     if cfg.meta_tokens else None)

    def reset(self, gen: torch.Generator):
        """The reference's init distributions, drawn from ``gen``."""
        Ly.normal_fill_(self.embed, gen, 0.02)
        self.final_norm.reset(gen)
        if self.lm_head is not None:
            self.lm_head.reset(gen)
        for blk in self.blocks:
            blk.reset(gen)
        if self.meta is not None:
            Ly.normal_fill_(self.meta, gen, 0.02)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable            # (seed) -> params
    forward: Callable         # (params, batch) -> logits (B, S, V)
    init_cache: Callable      # (batch, max_seq) -> cache
    prefill: Callable         # (params, batch, cache) -> (logits, cache)
    decode_step: Callable     # (params, tokens, cache, index) -> ...


def _logits(p: HybridLM, cfg: ModelConfig, x):
    h = Ly.rmsnorm(p.final_norm, x)
    if cfg.tie_embeddings:
        out = h @ p.embed.t().to(h.dtype)
    else:
        out = Ly.dense(p.lm_head, h)
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(cfg.padded_vocab, device=out.device)
        out = out.masked_fill(ids >= cfg.vocab, -1e9)
    return out


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _build_decoder(cfg: ModelConfig, dev: torch.device) -> Model:
    dt = getattr(torch, cfg.dtype)

    def init(seed: int) -> HybridLM:
        p = HybridLM(cfg, dev)
        p.reset(runtime.generator(seed, dev))
        return p

    def embed_inputs(p: HybridLM, tokens):
        tokens = torch.as_tensor(tokens, device=dev)
        B = tokens.shape[0]
        x = p.embed[tokens].to(dt)
        if cfg.meta_tokens:
            meta = p.meta.to(dt)[None].expand(B, -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    @torch.no_grad()
    def forward(p: HybridLM, batch) -> torch.Tensor:
        """Full-sequence logits (B, S, padded_vocab) of ``batch["tokens"]``
        (the meta-token positions dropped)."""
        x = embed_inputs(p, batch["tokens"])
        B, St = x.shape[:2]
        x, _ = Tr.stack_apply(p.blocks, cfg, x, _positions(B, St, dev))
        return _logits(p, cfg, x[:, cfg.meta_tokens:])

    def init_cache(batch_size: int, max_seq: int):
        """((k, v, kpos), (conv, h)) for the hybrid rolling cache:
        k, v (L, B, W, KV, hd) with W = min(window, max_seq) +
        meta_tokens, kpos (L, B, W) int32 (-1 = empty), conv (L, B,
        ssm_conv - 1, d_inner), h (L, B, d_inner, ssm_state) float32."""
        L, B = cfg.n_layers, batch_size
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        W = min(cfg.window or max_seq, max_seq) + cfg.meta_tokens
        attn = (torch.zeros((L, B, W, KV, hd), dtype=dt, device=dev),
                torch.zeros((L, B, W, KV, hd), dtype=dt, device=dev),
                torch.full((L, B, W), -1, dtype=torch.int32, device=dev))
        ssm = (torch.zeros((L, B, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt,
                           device=dev),
               torch.zeros((L, B, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=dev))
        return (attn, ssm)

    @torch.no_grad()
    def prefill(p: HybridLM, batch, cache):
        """Process the prompt; fill the rolling cache with the last W
        keys/values and the Mamba states; return the last token's logits
        (B, 1, padded_vocab) and the new cache."""
        x = embed_inputs(p, batch["tokens"])
        B, St = x.shape[:2]
        x, raw = Tr.stack_apply(p.blocks, cfg, x,
                                _positions(B, St, dev), collect_caches=True)
        (k_full, v_full), m_state = raw
        ck, cv, kpos = (t.clone() for t in cache[0])
        W = ck.shape[2]
        take = min(W, St)
        ck[:, :, W - take:] = k_full[:, :, St - take:].to(dt)
        cv[:, :, W - take:] = v_full[:, :, St - take:].to(dt)
        kpos[:, :, W - take:] = torch.arange(St - take, St, dtype=kpos.dtype,
                                             device=dev)
        x = x[:, cfg.meta_tokens:]
        return _logits(p, cfg, x[:, -1:]), ((ck, cv, kpos), m_state)

    @torch.no_grad()
    def decode_step(p: HybridLM, tokens, cache, index: int):
        """One decode step.  tokens: (B, 1); index: the token's absolute
        position (prompt + meta tokens + tokens decoded so far)."""
        x = p.embed[torch.as_tensor(tokens, device=dev)].to(dt)
        B = x.shape[0]
        pos = torch.full((B, 1), int(index), dtype=torch.long, device=dev)
        x, new_cache = Tr.stack_apply(p.blocks, cfg, x, pos,
                                      caches=cache, cache_index=int(index))
        return _logits(p, cfg, x), new_cache

    return Model(cfg, dev, init, forward, init_cache, prefill, decode_step)


def build_model(cfg: ModelConfig, device=runtime.DEFAULT_DEVICE) -> Model:
    """The serving functions of ``cfg`` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"the port builds {PORTED_FAMILIES}")
    return _build_decoder(cfg, runtime.resolve_device(device))
