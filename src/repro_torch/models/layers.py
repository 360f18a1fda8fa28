"""Layers of the port's LM substrate: the pieces of the reference's
``repro/models/layers.py`` that the ``hybrid`` (Hymba) block uses.

Parameters live in small ``nn.Module`` containers whose attribute names
are the reference pytree's keys (``attn.wq.w``, ``mamba.A_log``, ...), so a
reference parameter tree loads by name (``repro_torch.convert``).  Their
parameters never take gradients: the port serves, it does not train yet.
The arithmetic is in plain functions named as in the reference
(``dense``, ``rmsnorm``, ``apply_rope``, ``attention_apply``,
``attention_decode_rolling``, ``mlp_apply``, ``mamba_apply``), each
taking its module as ``p``:

* weights are float32 (``param_dtype``) and ``dense`` casts them to the
  activation dtype at each call, as the reference does;
* prefill attention goes through ``kernels.flash_attention`` and every
  Mamba scan through ``kernels.mamba_scan`` (the Hopper kernels on the
  card, their plain versions on the CPU); single-token decode attention
  against the rolling cache is plain PyTorch, as in the reference.

Not ported yet: M-RoPE sections, MLA and MoE, and attention with a full
(non-rolling) KV cache.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.mamba_scan.ops import selective_scan
from .config import ModelConfig

NEG_INF = float(torch.finfo(torch.float32).min)
RMS_EPS = 1e-6


def new_param(shape, device) -> nn.Parameter:
    """An uninitialized float32 parameter that takes no gradient."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def normal_fill_(t: torch.Tensor, gen: torch.Generator, scale: float):
    """Fill ``t`` in place with N(0, scale^2) draws from ``gen``."""
    t.normal_(generator=gen).mul_(scale)


# ---------------------------------------------------------------------------
# dense and norms
# ---------------------------------------------------------------------------
class Dense(nn.Module):
    """``w`` (d_in, d_out), optional bias ``b`` (d_out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None):
        super().__init__()
        self.w = new_param((d_in, d_out), device)
        self.b = new_param((d_out,), device) if bias else None

    def reset(self, gen: torch.Generator):
        """The reference's ``dense_init``: N(0, 1) / sqrt(d_in), zero bias."""
        normal_fill_(self.w, gen, 1.0 / math.sqrt(self.w.shape[0]))
        if self.b is not None:
            self.b.zero_()


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = new_param((d,), device)

    def reset(self, gen: torch.Generator = None):
        self.scale.fill_(1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    """RMS normalisation in float32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + RMS_EPS) * p.scale).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Rotates the two halves of the
    head dim in float32 and casts back to x's dtype."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)
    ang = positions.float()[..., None] * inv[None, None, :]   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; prefill through the flash-attention kernel)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = Dense(d, H * hd, cfg.qkv_bias, device)
        self.wk = Dense(d, KV * hd, cfg.qkv_bias, device)
        self.wv = Dense(d, KV * hd, cfg.qkv_bias, device)
        self.wo = Dense(H * hd, d, False, device)

    def reset(self, gen: torch.Generator):
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.reset(gen)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd)


def attention_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor):
    """Full-sequence (prefill) self-attention under the sliding window
    ``cfg.window``.  Returns (out, (k, v)) with
    k, v (B, S, KV, hd) rotated at their positions — the caller may build
    a cache from them."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope(_split_heads(dense(p.wq, x), H, hd), positions,
                   cfg.rope_theta)
    k = apply_rope(_split_heads(dense(p.wk, x), KV, hd), positions,
                   cfg.rope_theta)
    v = _split_heads(dense(p.wv, x), KV, hd).contiguous()
    out = flash_attention(q, k, v, mask_kind="window", window=cfg.window)
    B, S = x.shape[:2]
    return dense(p.wo, out.reshape(B, S, H * hd)), (k, v)


def attention_decode_rolling(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                             position: int, cache):
    """Single-token decode against an O(window) rolling KV cache, keys
    visible within ``cfg.window`` of ``position``.

    cache = (k (B, W, KV, hd), v (B, W, KV, hd), kpos (B, W) int32, -1 =
    empty); keys are stored rotated at their absolute positions.  The
    oldest entry rolls out, the new token's key rolls in.  Returns (out,
    new_cache)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = x.shape[0]
    pos2d = torch.full((B, 1), int(position), dtype=torch.long,
                       device=x.device)
    q = apply_rope(_split_heads(dense(p.wq, x), H, hd), pos2d, cfg.rope_theta)
    k = apply_rope(_split_heads(dense(p.wk, x), KV, hd), pos2d,
                   cfg.rope_theta)
    v = _split_heads(dense(p.wv, x), KV, hd)

    ck, cv, kpos = cache
    ck = torch.cat([ck[:, 1:], k.to(ck.dtype)], dim=1)
    cv = torch.cat([cv[:, 1:], v.to(cv.dtype)], dim=1)
    kpos = torch.cat([kpos[:, 1:], pos2d.to(kpos.dtype)], dim=1)

    rep = H // KV
    kf = ck.repeat_interleave(rep, dim=2).float()
    vf = cv.repeat_interleave(rep, dim=2).float()
    qf = q.float() / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    valid = (kpos >= 0) & (kpos <= position) & (position - kpos < cfg.window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vf).to(x.dtype)
    out = dense(p.wo, out.reshape(B, 1, H * hd))
    return out, (ck, cv, kpos)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wg = Dense(d, f, device=device)
        self.wu = Dense(d, f, device=device)
        self.wd = Dense(f, d, device=device)

    def reset(self, gen: torch.Generator):
        for m in (self.wg, self.wu, self.wd):
            m.reset(gen)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return dense(p.wd, F.silu(dense(p.wg, x)) * dense(p.wu, x))


# ---------------------------------------------------------------------------
# Mamba-1 block (the Hymba SSM heads)
# ---------------------------------------------------------------------------
class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        dt_rank = max(d // 16, 1)
        self.in_proj = Dense(d, 2 * di, device=device)
        self.conv_w = new_param((dc, di), device)
        self.conv_b = new_param((di,), device)
        self.x_proj = Dense(di, dt_rank + 2 * ds, device=device)
        self.dt_proj = Dense(dt_rank, di, bias=True, device=device)
        self.A_log = new_param((di, ds), device)
        self.D = new_param((di,), device)
        self.out_proj = Dense(di, d, device=device)

    def reset(self, gen: torch.Generator):
        """The reference's ``mamba_init`` distributions."""
        self.in_proj.reset(gen)
        normal_fill_(self.conv_w, gen, 0.2)
        self.conv_b.zero_()
        self.x_proj.reset(gen)
        self.dt_proj.reset(gen)
        ds = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=self.A_log.device)))
        self.D.fill_(1.0)
        self.out_proj.reset(gen)


def mamba_apply(p: Mamba, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Mamba-1: in-proj -> causal conv1d -> selective scan -> gate.

    state: None (full-sequence scan from a zero state) or (conv_state
    (B, dc-1, di), ssm_state (B, di, ds)) to continue from.  Returns
    (y, (new_conv_state, h_T))."""
    B, S, d = x.shape
    di, ds, dc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dt_rank = max(d // 16, 1)

    xs, z = dense(p.in_proj, x).chunk(2, dim=-1)            # (B, S, di)
    if state is None:
        h0 = None
        prev = torch.zeros((B, dc - 1, di), dtype=xs.dtype, device=x.device)
    else:
        prev, h0 = state
        prev = prev.to(xs.dtype)
    xc = torch.cat([prev, xs], dim=1)
    new_conv = (xc[:, -(dc - 1):] if dc > 1
                else torch.zeros((B, 0, di), dtype=xs.dtype, device=x.device))
    w = p.conv_w.to(xs.dtype)
    conv = xc[:, 0:S] * w[0]
    for i in range(1, dc):
        conv = conv + xc[:, i:i + S] * w[i]
    u = F.silu(conv + p.conv_b.to(xs.dtype))

    dt, Bc, Cc = dense(p.x_proj, u).split([dt_rank, ds, ds], dim=-1)
    pre = dense(p.dt_proj, dt)
    delta = torch.logaddexp(pre, torch.zeros_like(pre)).float().contiguous()
    A = -torch.exp(p.A_log)                                  # (di, ds)

    uf = u.float().contiguous()
    y, hT = selective_scan(uf, delta, A, Bc.float().contiguous(),
                           Cc.float().contiguous(),
                           h0=None if h0 is None else h0.contiguous())
    y = (y + uf * p.D).to(x.dtype)
    y = y * F.silu(z)
    return dense(p.out_proj, y), (new_conv, hT)
