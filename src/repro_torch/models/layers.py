"""Layers of the port's LM substrate: the reference's
``repro/models/layers.py`` for every family.

Parameters live in small ``nn.Module`` containers whose attribute names
are the reference pytree's keys (``attn.wq.w``, ``moe.wg``,
``attn.wkv_down.w``, ``mamba.A_log``, ...), so a reference parameter tree
loads by name (``repro_torch.convert``).  Parameters are made with
``requires_grad=False`` for serving; training turns them on
(``launch.train.make_train_state``), and every layer function is then
differentiable: nothing autograd needs is written in place (the caches'
in-place writes belong to serving, under ``no_grad``), attention and the
scan are differentiated by their kernels' backward passes.  The
arithmetic is in plain functions named as in the reference (``dense``,
``rmsnorm``, ``apply_rope``, ``attention_apply``,
``attention_decode_rolling``, ``mla_apply``, ``mlp_apply``,
``moe_apply``, ``mamba_apply``), each taking its module as ``p``:

* weights are float32 (``param_dtype``) and ``dense`` casts them to the
  activation dtype at each call, as the reference does;
* every attention over a sequence or a full KV cache goes through
  ``kernels.flash_attention`` and every Mamba scan through
  ``kernels.mamba_scan`` (the Hopper kernels on the card, their plain
  versions on the CPU); single-token decode against Hymba's rolling cache
  is plain PyTorch, as in the reference;
* a full KV cache (``attention_apply``) or MLA's latent cache
  (``mla_apply``) is written IN PLACE at ``cache_index`` and returned, as
  the model's ``prefill`` / ``decode_step`` return the cache they were
  given (no copy of a cache a step).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.mamba_scan.ops import selective_scan
from ..parallel import ctx
from .config import ModelConfig

NEG_INF = float(torch.finfo(torch.float32).min)
RMS_EPS = 1e-6
# logical layouts of ``ctx.shard`` (no-ops without a sharding context)
HEADS = ("batch", "seq", "heads", None)
BATCH4 = ("batch", None, None, None)
EXPERTS = ("ep", None, None)


def new_param(shape, device) -> nn.Parameter:
    """An uninitialized float32 parameter that takes no gradient until
    training asks for one."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def normal_fill_(t: torch.Tensor, gen: torch.Generator, scale: float):
    """Fill ``t`` in place with N(0, scale^2) draws from ``gen``."""
    t.normal_(generator=gen).mul_(scale)


def reset_children(m: nn.Module, gen: torch.Generator):
    """Draw the reference's init distributions for every child module of
    ``m``, in order (into the members of a ``ModuleList``)."""
    for c in m.children():
        if isinstance(c, nn.ModuleList):
            reset_children(c, gen)
        else:
            c.reset(gen)


# ---------------------------------------------------------------------------
# dense and norms
# ---------------------------------------------------------------------------
class Dense(nn.Module):
    """``w`` (d_in, d_out), optional bias ``b`` (d_out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None, scale: Optional[float] = None):
        super().__init__()
        self.w = new_param((d_in, d_out), device)
        self.b = new_param((d_out,), device) if bias else None
        self.scale = 1.0 / math.sqrt(d_in) if scale is None else scale

    def reset(self, gen: torch.Generator):
        """The reference's ``dense_init``: N(0, 1) x scale (1 / sqrt(d_in)
        unless given), zero bias."""
        normal_fill_(self.w, gen, self.scale)
        if self.b is not None:
            self.b.zero_()


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    x = ctx.gather_inner(x)
    y = ctx.own_grad_layout(x @ ctx.gather_fsdp(p.w.to(x.dtype), x))
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
# rotary embeddings (RoPE, and 3-section M-RoPE for Qwen2-VL)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S), or (B, S, 3) with M-RoPE
    ``sections`` (t, h, w), whose sizes sum to D / 2: the rotary
    frequencies are split into the sections, each rotated by its own
    position stream.  Rotates the two halves of the head dim in float32
    and casts back to x's dtype."""
    B, S, H, D = x.shape
    inv = rope_freqs(D, theta, x.device)
    if sections:
        if positions.dim() != 3 or sum(sections) != D // 2:
            raise ValueError(f"apply_rope: M-RoPE sections {sections} need "
                             f"(B, S, 3) positions and sum to {D // 2}, got "
                             f"positions {tuple(positions.shape)}")
        pos = torch.cat([positions[..., i:i + 1].float().expand(B, S, sec)
                         for i, sec in enumerate(sections)], dim=-1)
        ang = pos * inv[None, None, :]                      # (B, S, D/2)
    else:
        ang = positions.float()[..., None] * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; causal / sliding-window / cross) via the flash-attention op
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = Dense(d, H * hd, cfg.qkv_bias, device)
        self.wk = Dense(d, KV * hd, cfg.qkv_bias, device)
        self.wv = Dense(d, KV * hd, cfg.qkv_bias, device)
        self.wo = Dense(H * hd, d, False, device)

    reset = reset_children


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return ctx.reshape(x, B, S, n, hd)


def attention_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, kv_x=None, kv_positions=None,
                    mask_kind: str = "causal", window: int = 0,
                    kv_cache=None, cache_index: Optional[int] = None,
                    use_rope: bool = True):
    """Attention of x's queries over the keys of ``kv_x`` (cross; at
    ``kv_positions``) or of x itself, under ``mask_kind`` (``causal``,
    ``window`` of ``window`` keys, or ``none``).

    ``kv_cache`` = (k, v), each (B, S_cache, KV, hd): with ``cache_index``
    (an int: prefill writes at 0, decode at the token's position) the new
    keys and values are written into it IN PLACE at ``cache_index``, and
    the queries, at absolute positions [cache_index, cache_index + S),
    attend over the whole cache with ``kv_valid_len = cache_index + S``.
    Returns (out, new_kv_cache): the cache, or without one the (k, v) of
    this call, rotated at their positions."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = ctx.shard(_split_heads(dense(p.wq, x), H, hd), HEADS)
    k = ctx.shard(_split_heads(dense(p.wk, src), KV, hd), HEADS)
    v = ctx.shard(_split_heads(dense(p.wv, src), KV, hd), HEADS)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        kp = positions if kv_positions is None else kv_positions
        k = apply_rope(k, kp, cfg.rope_theta, cfg.mrope_sections)
    B, S = x.shape[:2]
    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_index is not None:
            # the new token's q, k, v replicated over the model axis: the
            # cache keeps its layout (the reference's flash-decoding note)
            q, k, v = (ctx.shard(t, BATCH4) for t in (q, k, v))
            ctx.write_seq(ck, k, cache_index)
            ctx.write_seq(cv, v, cache_index)
        k, v = ck, cv
    else:
        k, v = k.contiguous(), v.contiguous()
    kv_len = None if cache_index is None else cache_index + S
    out = ctx.split_key_attention(q, k, v, kv_len) if mask_kind in (
        "causal", "none") and not window else None
    if out is None:
        out = flash_attention(q.contiguous(), k, v, mask_kind=mask_kind,
                              window=window, kv_valid_len=kv_len)
    out = ctx.shard(out, BATCH4 if cache_index is not None else HEADS)
    out = ctx.own_grad_layout(out.reshape(B, S, H * hd))
    return dense(p.wo, out), (k, v)


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
# MLA — multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                         cfg.v_head_dim)
        # queries: full-rank projection to per-head (nope + rope) dims
        self.wq = Dense(d, H * (dn + dr), device=device)
        # KV: compress to latent r (+ the shared rope key), then up-project
        self.wkv_down = Dense(d, r + dr, device=device)
        self.kv_norm = RMSNorm(r, device)
        self.wk_up = Dense(r, H * dn, device=device)
        self.wv_up = Dense(r, H * dv, device=device)
        self.wo = Dense(H * dv, d, device=device)

    reset = reset_children


def mla_apply(p: MLA, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, kv_cache=None,
              cache_index: Optional[int] = None):
    """MLA with the compressed latent as the KV cache: (B, S_cache, r +
    dr) instead of (B, S, 2 H hd).  With ``cache_index`` the new latent is
    written into ``kv_cache`` IN PLACE at ``cache_index`` and the queries
    attend over the whole cache (``kv_valid_len = cache_index + S``); keys
    and values are up-projected from the latent at every call, and the
    shared rope key (rotated at the cache's absolute positions) is
    broadcast over the heads.  Returns (out, new_cache): the cache, or the
    new latent when ``kv_cache`` is given without an index, else None."""
    H = cfg.n_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    B, S, _ = x.shape

    q = ctx.shard(ctx.reshape(dense(p.wq, x), B, S, H, dn + dr), HEADS)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    qf = torch.cat([q[..., :dn], q_rope], dim=-1)

    latent = dense(p.wkv_down, x)                          # (B, S, r + dr)
    if kv_cache is not None and cache_index is not None:
        ctx.write_seq(kv_cache, latent, cache_index)
        latent = kv_cache
    new_cache = latent if kv_cache is not None else None
    c_kv = rmsnorm(p.kv_norm, latent[..., :r])
    Sk = c_kv.shape[1]
    kpos = torch.arange(Sk, device=x.device)[None].expand(B, Sk)
    k_rope = apply_rope(latent[:, :, None, r:], kpos, cfg.rope_theta)
    if cache_index is not None and S == 1 and ctx.sequence_sharded(latent):
        # decode over a sequence-sharded latent cache: each rank
        # up-projects its own block of the cache for every head, and the
        # blocks' attention combines by flash-decoding
        # (``ctx.split_key_attention``), the cache never gathered
        k_nope = ctx.rows_matmul(c_kv, p.wk_up.w.to(c_kv.dtype)).reshape(
            B, Sk, H, dn)
        v = ctx.rows_matmul(c_kv, p.wv_up.w.to(c_kv.dtype)).reshape(
            B, Sk, H, dv)
        qf = ctx.shard(qf, BATCH4)
    else:
        k_nope = ctx.shard(ctx.reshape(dense(p.wk_up, c_kv), B, Sk, H, dn),
                           HEADS)
        v = ctx.shard(ctx.reshape(dense(p.wv_up, c_kv), B, Sk, H, dv),
                      HEADS)
    k = torch.cat([k_nope, k_rope.expand(B, Sk, H, dr)], dim=-1)

    kv_len = None if cache_index is None else cache_index + S
    out = ctx.split_key_attention(qf, k, v, kv_len)
    if out is None:
        out = flash_attention(qf, k, v, mask_kind="causal",
                              kv_valid_len=kv_len)
    out = ctx.own_grad_layout(out.reshape(B, S, H * dv))
    return dense(p.wo, out), new_cache


# ---------------------------------------------------------------------------
# MLPs: dense SwiGLU and capacity-factor MoE
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wg = Dense(d, f, device=device)
        self.wu = Dense(d, f, device=device)
        self.wd = Dense(f, d, device=device)

    reset = reset_children


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(p.wg, x)) * dense(p.wu, x)
    if h.dim() == 3:
        h = ctx.shard(h, ("batch", "seq", "tp"))
    return dense(p.wd, h)


class MoE(nn.Module):
    """``router`` (d, E), expert tensors ``wg`` / ``wu`` (E, d, f) and
    ``wd`` (E, f, d), and the ``shared`` experts' MLP (d_ff = f x
    n_shared_experts) when the config has them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
        self.router = Dense(d, E, device=device, scale=0.02)
        self.wg = new_param((E, d, f), device)
        self.wu = new_param((E, d, f), device)
        self.wd = new_param((E, f, d), device)
        self.shared = (MLP(cfg, device, d_ff=f * cfg.n_shared_experts)
                       if cfg.n_shared_experts else None)

    def reset(self, gen: torch.Generator):
        """The reference's ``moe_init`` distributions."""
        d, f = self.wg.shape[1], self.wg.shape[2]
        self.router.reset(gen)
        normal_fill_(self.wg, gen, 1.0 / math.sqrt(d))
        normal_fill_(self.wu, gen, 1.0 / math.sqrt(d))
        normal_fill_(self.wd, gen, 1.0 / math.sqrt(f))
        if self.shared is not None:
            self.shared.reset(gen)


def _moe_route(p: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """The router: softmax over E in float32, top-k renormalized, each
    (token, choice)'s position in its expert's queue (token order), the
    capacity, and the load-balancing aux loss.  Returns (gate_vals (T, K),
    gate_idx (T, K), pos (T, K), in_cap (T, K), cap, onehot (T, K, E),
    aux)."""
    E, K = cfg.n_experts, cfg.top_k
    T = xt.shape[0]
    probs = torch.softmax(dense(p.router, xt).float(), dim=-1)   # (T, E)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)            # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(int(cfg.capacity_factor * T * K / E), 1)
    onehot = F.one_hot(gate_idx, E).to(torch.int32)              # (T, K, E)
    pos = _queue_positions(onehot)
    in_cap = (pos >= 0) & (pos < cap)
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=1).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return gate_vals, gate_idx, pos, in_cap, cap, onehot, aux


def _queue_positions(onehot: torch.Tensor) -> torch.Tensor:
    """onehot (..., T, K, E) -> (..., T, K): each choice's 0-based position
    among the choices of its expert, in (token, choice) order."""
    *lead, T, K, E = onehot.shape
    flat = onehot.reshape(*lead, T * K, E)
    pos_e = torch.cumsum(flat, dim=-2) * flat - 1
    return pos_e.reshape(*lead, T, K, E).amax(dim=-1)


def _moe_experts(p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """The batched expert FFN over (E, cap, d) buffers."""
    dt = xe.dtype
    h = ctx.shard(torch.bmm(xe, p.wg.to(dt)), ("ep", None, "tp"))
    u = ctx.shard(torch.bmm(xe, p.wu.to(dt)), ("ep", None, "tp"))
    return ctx.shard(torch.bmm(F.silu(h) * u, p.wd.to(dt)),
                     EXPERTS)                                  # (E, cap, d)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """Capacity-factor top-k MoE with static shapes: choices past an
    expert's capacity are dropped (the residual passes through).  Three
    dispatches (``cfg.moe_impl``), as in the reference:

    * ``einsum``, ``moe_groups`` 1: one-hot dispatch / combine products
      over (T, E, cap);
    * ``einsum``, ``moe_groups`` G > 1: tokens compete for capacity only
      within their group of T / G, the one-hots (G, T / G, E, cap / G);
    * ``gather``: tokens scattered into an (E cap + 1, d) buffer by row
      index (expert x cap + position; a dropped choice goes to the extra
      last row, which is cut off: no index leaves the buffer) and the
      results gathered back.

    Returns (out, aux_loss)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    # tokens sharded as the batch was (a sharded layout's backward then
    # views the gradient back to (B, S, d) from that layout)
    xt = ctx.shard(x.reshape(T, d), ("batch", None))
    gate_vals, gate_idx, pos, in_cap, cap, onehot, aux = _moe_route(p, cfg,
                                                                    xt)

    if cfg.moe_impl == "gather":
        buf_idx = torch.where(in_cap, gate_idx * cap + pos,
                              E * cap).reshape(-1)               # (T*K,)
        tok_idx = torch.arange(T, device=x.device).repeat_interleave(K)
        xe = torch.zeros((E * cap + 1, d), dtype=dt,
                         device=x.device).index_add(0, buf_idx, xt[tok_idx])
        ye = _moe_experts(p, ctx.shard(xe[:E * cap].reshape(E, cap, d),
                                       EXPERTS))
        flat = torch.cat([ye.reshape(E * cap, d),
                          torch.zeros((1, d), dtype=ye.dtype,
                                      device=x.device)])
        picked = flat[buf_idx].reshape(T, K, d)
        w = (gate_vals * in_cap.float())[..., None].to(dt)
        out = (picked * w).sum(dim=1)
    elif cfg.moe_groups > 1:
        G = cfg.moe_groups
        Tg, capg = T // G, max(cap // G, 1)
        pos = _queue_positions(onehot.reshape(G, Tg, K, E))     # (G, Tg, K)
        in_cap_g = (pos >= 0) & (pos < capg)
        pos_c = torch.clamp(pos, 0, capg - 1)
        ohg = onehot.reshape(G, Tg, K, E).to(dt)
        disp = torch.einsum(
            "gtke,gtkc->gtec", ohg,
            F.one_hot(pos_c, capg).to(dt) * in_cap_g[..., None].to(dt))
        comb = disp * torch.einsum(
            "gtk,gtke->gte", gate_vals.reshape(G, Tg, K) * in_cap_g.float(),
            ohg.float()).to(dt)[..., None]
        xe = torch.einsum("gtd,gtec->egcd", xt.reshape(G, Tg, d), disp)
        ye = _moe_experts(p, ctx.shard(xe.reshape(E, G * capg, d),
                                       EXPERTS))
        out = ctx.combine_experts("egcd,gtec->gtd",
                                  ye.reshape(E, G, capg, d),
                                  comb).reshape(T, d)
    else:
        pos_c = torch.clamp(pos, 0, cap - 1)
        disp = torch.einsum(
            "tke,tkc->tec", onehot.to(dt),
            F.one_hot(pos_c, cap).to(dt) * in_cap[..., None].to(dt))
        comb = disp * torch.einsum(
            "tk,tke->te", gate_vals * in_cap.float(),
            onehot.float()).to(dt)[:, :, None]
        xe = ctx.shard(torch.einsum("td,tec->ecd", xt, disp),
                       EXPERTS)                                 # (E, cap, d)
        out = ctx.combine_experts("ecd,tec->td", _moe_experts(p, xe), comb)

    if p.shared is not None:
        out = out + mlp_apply(p.shared, xt)
    return ctx.reshape(out, B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba-1 block (Falcon-Mamba, and the Hymba SSM heads)
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
    xs = ctx.shard(xs, ("batch", "seq", "tp"))
    z = ctx.shard(z, ("batch", "seq", "tp"))
    if state is None:
        h0 = None
        prev = torch.zeros((B, dc - 1, di), dtype=xs.dtype, device=x.device)
    else:
        prev, h0 = state
        prev = prev.to(xs.dtype)
    xc = torch.cat([prev, xs], dim=1)
    new_conv = (xc[:, -(dc - 1):] if dc > 1
                else torch.zeros((B, 0, di), dtype=xs.dtype, device=x.device))
    if S > 1:
        # a view would keep this layer's whole (B, S + dc - 1, di) input
        # alive until the stack's new caches are stacked
        new_conv = new_conv.clone()
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
