"""Plain PyTorch versions of flash attention: the oracle the CUDA kernel is
held against, and the CPU path of ``ops.flash_attention``.

* ``attention_ref`` — ``repro/kernels/flash_attention/ref.py``: naive
  materialized-scores attention with GQA head grouping, softmax in
  float32.
* ``flash_attention_blocked`` — the online-softmax structure of the
  reference's blocked path (``repro/kernels/flash_attention/ops.py``):
  a loop over KV blocks carrying the running max, sum and accumulator,
  with the same masks and the same guards for fully masked rows
  (``safe_m``, ``alpha = 0``, ``l >= 1e-20``).
* ``flash_attention_tc_mirror`` — the bf16 tensor-core kernel's
  arithmetic (``csrc/flash_attention_wgmma.cu``) for tests: the scale
  applied after the product in the log2 domain, P rounded to bf16 before
  P V, l summed from the float32 P.  Never on the main path.

Layouts are the reference's: q (B, Sq, H, D); k/v (B, Sk, KV, D | Dv) with
H % KV == 0.  Masks: ``causal`` — key j visible to the query at absolute
position p iff j <= p; ``window`` — causal and p - j < window; ``none`` —
all keys.  With ``kv_valid_len`` the queries sit at absolute positions
[kv_valid_len - Sq, kv_valid_len) and keys at or past kv_valid_len are
masked; otherwise query i sits at position i.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

BLOCK_K = 512
TC_BLOCK_K = 64     # keys per tile of the tensor-core kernel
NEG_INF = float(torch.finfo(torch.float32).min)
MASK_KINDS = ("causal", "window", "none")


def _positions(Sq: int, Sk: int, kv_valid_len: Optional[int], device):
    """Absolute query positions (Sq,) and the number of valid keys."""
    if kv_valid_len is None:
        return torch.arange(Sq, device=device), Sk
    return kv_valid_len - Sq + torch.arange(Sq, device=device), kv_valid_len


def _mask(q_pos, k_ids, valid_len: int, mask_kind: str, window: int):
    """(Sq, nk) bool: which keys each query sees."""
    mask = (k_ids[None, :] < valid_len).expand(q_pos.shape[0], -1)
    if mask_kind in ("causal", "window"):
        mask = mask & (k_ids[None, :] <= q_pos[:, None])
    if mask_kind == "window":
        mask = mask & (q_pos[:, None] - k_ids[None, :] < window)
    elif mask_kind not in MASK_KINDS:
        raise ValueError(f"unknown mask kind {mask_kind!r}")
    return mask


def attention_ref(q, k, v, mask_kind: str = "causal", window: int = 0,
                  kv_valid_len: Optional[int] = None):
    """Returns (B, Sq, H, Dv) in q.dtype; softmax in float32.  A fully
    masked row averages v uniformly, as the reference oracle does."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kf = k.repeat_interleave(rep, dim=2).float()
    vf = v.repeat_interleave(rep, dim=2).float()
    qf = q.float() / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos, valid_len = _positions(Sq, Sk, kv_valid_len, q.device)
    mask = _mask(q_pos, torch.arange(Sk, device=q.device), valid_len,
                 mask_kind, window)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_attention_blocked(q, k, v, mask_kind: str = "causal",
                            window: int = 0,
                            kv_valid_len: Optional[int] = None,
                            block_k: int = BLOCK_K):
    """Online-softmax attention over KV blocks of ``block_k`` keys; O(Sq *
    block_k) scores live at a time.  A fully masked row gives 0."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // KV
    bk = max(1, min(block_k, Sk))
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(D))   # (B, H, Sq, D)
    q_pos, valid_len = _positions(Sq, Sk, kv_valid_len, q.device)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), device=q.device)
    for k0 in range(0, Sk, bk):
        kf = k[:, k0:k0 + bk].repeat_interleave(rep, dim=2).float()
        vf = v[:, k0:k0 + bk].repeat_interleave(rep, dim=2).float()
        s = torch.einsum("bhqd,bkhd->bhqk", qf, kf)
        mask = _mask(q_pos, torch.arange(k0, k0 + kf.shape[1],
                                         device=q.device),
                     valid_len, mask_kind, window)[None, None]
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # guard fully masked rows (m == -inf) against NaNs
        safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - safe), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - safe))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, vf)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_tc_mirror(q, k, v, mask_kind: str = "causal",
                              window: int = 0,
                              kv_valid_len: Optional[int] = None):
    """The tensor-core kernel's rounding scheme: per tile of ``TC_BLOCK_K``
    keys, raw scores S = q k^T in float32 and the rows' running max of
    them; P = exp2(S c - m c) with c = log2(e) / sqrt(D) applied after the
    product; l adds the float32 P; P is rounded to bfloat16 before P V.
    Masks and fully-masked-row guards as in ``flash_attention_blocked``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // KV
    c = torch.tensor(math.log2(math.e) / math.sqrt(D), dtype=torch.float32)
    qf = q.float().transpose(1, 2)                       # (B, H, Sq, D)
    q_pos, valid_len = _positions(Sq, Sk, kv_valid_len, q.device)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), device=q.device)
    for k0 in range(0, Sk, TC_BLOCK_K):
        kf = k[:, k0:k0 + TC_BLOCK_K].repeat_interleave(rep, dim=2).float()
        vf = v[:, k0:k0 + TC_BLOCK_K].repeat_interleave(rep, dim=2).float()
        s = torch.einsum("bhqd,bkhd->bhqk", qf, kf)
        mask = _mask(q_pos, torch.arange(k0, k0 + kf.shape[1],
                                         device=q.device),
                     valid_len, mask_kind, window)[None, None]
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp2(s * c - safe * c), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0,
                            torch.exp2((m - safe) * c))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)
    return out.transpose(1, 2).to(q.dtype)
