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
* ``flash_attention_bwd_blocked`` — the backward of the reference's custom
  VJP (``_fa_diff_bwd``): delta = rowsum(dout * out), and per KV block
  P = exp(S - lse), dv, dP, dS = P (dP - delta), dq, dk, with GQA's query
  heads folded back onto their KV head.  The CPU path of
  ``ops.flash_attention_bwd`` and the oracle its CUDA kernel is held
  against.
* ``split_tf32``, ``einsum_tf32`` and ``matmul_tf32x3`` — the float32
  kernels' arithmetic on the tensor cores (``csrc/tf32_common.cuh``): a
  float32 value split into a TF32 high part and a TF32 low part, and a
  product as three TF32 products of the parts (3xTF32) or, for
  comparison, one.  ``flash_attention_blocked`` and
  ``flash_attention_bwd_blocked`` take ``products=3`` (or 1) to run their
  matrix products that way: the CPU's evidence of why the kernels take
  three.  Never on the main path (``products=None`` there: plain float32).
* ``flash_attention_tc_mirror`` — the bf16 tensor-core kernel's
  arithmetic (``csrc/flash_attention_wgmma.cu``) for tests: the scale
  applied after the product in the log2 domain, P rounded to bf16 before
  P V, l summed from the float32 P.  Never on the main path.
* ``flash_attention_bwd_tc_mirror`` — the bf16 tensor-core backward's
  arithmetic (``csrc/flash_attention_bwd_wgmma.cu``) for tests: float32
  products of the inputs, P = exp2(S c - lse log2 e), P and dS rounded to
  the inputs' dtype before the products they feed, the scale at the end.
  Never on the main path.  ``tc_bwd_agreement`` is the gate the kernels
  are held to against it.

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


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 (10 mantissa bits, ties
    away from zero) by integer operations on its bits, as the kernels do:
    add half a TF32 unit to the magnitude, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) of float32 ``x``: hi = x rounded to the nearest TF32, lo =
    x - hi (exact in float32) rounded likewise, so |x - hi - lo| <= 2^-22
    |x| (finite x of at least 2^-114, where lo is a normal float; below
    that lo loses bits as a subnormal)."""
    x = x.float()
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def einsum_tf32(eq: str, a: torch.Tensor, b: torch.Tensor,
                products: int = 3) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in float32 with TF32 operands: with
    ``products=3`` a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32, small terms
    first, as the kernels sum them), with ``products=1`` a_hi b_hi."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if products == 1:
        return torch.einsum(eq, ah, bh)
    if products != 3:
        raise ValueError(f"products must be 1 or 3, got {products}")
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor,
                  products: int = 3) -> torch.Tensor:
    """``a @ b`` (matrices or batches of them) as ``einsum_tf32``:
    hi hi + hi lo + lo hi, or hi hi alone with ``products=1``."""
    return einsum_tf32("...ik,...kj->...ij", a, b, products)


def _einsum(eq: str, a, b, products: Optional[int]):
    """Plain float32 ``torch.einsum`` (``products=None``) or the kernels'
    TF32 products (``einsum_tf32``)."""
    if products is None:
        return torch.einsum(eq, a, b)
    return einsum_tf32(eq, a, b, products)


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
                            block_k: int = BLOCK_K, return_lse: bool = False,
                            products: Optional[int] = None):
    """Online-softmax attention over KV blocks of ``block_k`` keys; O(Sq *
    block_k) scores live at a time.  A fully masked row gives 0.  With
    ``return_lse`` also each row's log-sum-exp of its scaled scores, (B,
    H, Sq) float32 (the reference's ``_fwd_with_lse``).  ``products`` (3
    or 1) runs the two matrix products as ``einsum_tf32`` does."""
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
        s = _einsum("bhqd,bkhd->bhqk", qf, kf, products)
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
        acc = acc * alpha + _einsum("bhqk,bkhd->bhqd", p, vf, products)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-20)).transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(torch.clamp(l, min=1e-20)))[..., 0]
    return out


def flash_attention_bwd_blocked(q, k, v, out, lse, dout,
                                mask_kind: str = "causal", window: int = 0,
                                kv_valid_len: Optional[int] = None,
                                block_k: int = BLOCK_K,
                                products: Optional[int] = None):
    """Gradients (dq, dk, dv) of attention, in q's, k's and v's dtypes, from
    the forward's ``out`` and ``lse`` (B, H, Sq) and the gradient ``dout``
    of ``out``: the reference's ``_fa_diff_bwd`` in float32, block by KV
    block of ``block_k`` keys.  ``products`` (3 or 1) runs the five matrix
    products as ``einsum_tf32`` does."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // KV
    bk = max(1, min(block_k, Sk))
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    dof = dout.float().transpose(1, 2)                   # (B, H, Sq, Dv)
    delta = (dof * out.float().transpose(1, 2)).sum(-1)  # (B, H, Sq)
    q_pos, valid_len = _positions(Sq, Sk, kv_valid_len, q.device)
    dq = torch.zeros((B, Sq, H, D), device=q.device)
    dk = torch.zeros((B, Sk, KV, D), device=q.device)
    dv = torch.zeros((B, Sk, KV, Dv), device=q.device)
    for k0 in range(0, Sk, bk):
        kf = k[:, k0:k0 + bk].repeat_interleave(rep, dim=2).float()
        vf = v[:, k0:k0 + bk].repeat_interleave(rep, dim=2).float()
        n = kf.shape[1]
        s = _einsum("bqhd,bkhd->bhqk", qf * scale, kf, products)
        mask = _mask(q_pos, torch.arange(k0, k0 + n, device=q.device),
                     valid_len, mask_kind, window)[None, None]
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dv_b = _einsum("bhqk,bhqd->bkhd", p, dof, products)  # (B, n, H, Dv)
        dp = _einsum("bhqd,bkhd->bhqk", dof, vf, products)
        ds = p * (dp - delta[..., None])
        dq += scale * _einsum("bhqk,bkhd->bqhd", ds, kf, products)
        dk_b = scale * _einsum("bhqk,bqhd->bkhd", ds, qf, products)
        # GQA: fold query-head groups back onto their kv head
        dv[:, k0:k0 + n] = dv_b.reshape(B, n, KV, rep, Dv).sum(3)
        dk[:, k0:k0 + n] = dk_b.reshape(B, n, KV, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def flash_attention_bwd_tc_mirror(q, k, v, out, lse, dout,
                                  mask_kind: str = "causal", window: int = 0,
                                  kv_valid_len: Optional[int] = None,
                                  block_k: int = BLOCK_K,
                                  with_terms: bool = False):
    """The tensor-core backward's rounding scheme: delta = rowsum(dout *
    out) in float32; S = q k^T and dP = dout v^T in float32 from the
    inputs; P = exp2(S c - lse log2 e) with c = log2(e) / sqrt(D) applied
    after the product, 0 where masked; dS = P (dP - delta); P and dS
    rounded to q's dtype before dv += P^T dout, dk += dS^T q and dq += dS
    k, which sum in float32; dq and dk times 1/sqrt(D) at the end, each
    result rounded once to its dtype.  On float32 inputs nothing rounds
    but the float32 arithmetic.  Masks and GQA folding as
    ``flash_attention_bwd_blocked``.

    With ``with_terms`` it returns ((dq, dk, dv), (tq, tk, tv)): each
    gradient's sum of the magnitudes of its rounded terms, float32 (tq =
    sum_j |dS_ij| |k_j| / sqrt(D), tk likewise over i with |q_i|, tv =
    sum_i |P_ij| |dout_i|), the scale of what a change of those roundings
    can move."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // KV
    bk = max(1, min(block_k, Sk))
    c = torch.tensor(math.log2(math.e) / math.sqrt(D), dtype=torch.float32)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    nl = lse.float() * -math.log2(math.e)                # (B, H, Sq)
    rnd = lambda x: x.to(q.dtype).float()
    qf = q.float()
    dof = dout.float().transpose(1, 2)                   # (B, H, Sq, Dv)
    delta = (dof * out.float().transpose(1, 2)).sum(-1)  # (B, H, Sq)
    q_pos, valid_len = _positions(Sq, Sk, kv_valid_len, q.device)
    grads = [torch.zeros((B, Sq, H, D), device=q.device),
             torch.zeros((B, Sk, KV, D), device=q.device),
             torch.zeros((B, Sk, KV, Dv), device=q.device)]
    terms = [torch.zeros_like(g) for g in grads] if with_terms else None
    for k0 in range(0, Sk, bk):
        kf = k[:, k0:k0 + bk].repeat_interleave(rep, dim=2).float()
        vf = v[:, k0:k0 + bk].repeat_interleave(rep, dim=2).float()
        n = kf.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        mask = _mask(q_pos, torch.arange(k0, k0 + n, device=q.device),
                     valid_len, mask_kind, window)[None, None]
        p = torch.where(mask, torch.exp2(s * c + nl[..., None]), 0.0)
        dp = torch.einsum("bhqd,bkhd->bhqk", dof, vf)
        ds = rnd(p * (dp - delta[..., None]))
        for out_, mag in ((grads, lambda x: x),) + (
                ((terms, torch.abs),) if with_terms else ()):
            dsm = mag(ds)
            out_[0] += torch.einsum("bhqk,bkhd->bqhd", dsm, mag(kf))
            dk_b = torch.einsum("bhqk,bqhd->bkhd", dsm, mag(qf))
            dv_b = torch.einsum("bhqk,bhqd->bkhd", mag(rnd(p)), mag(dof))
            # GQA: fold query-head groups back onto their kv head
            out_[1][:, k0:k0 + n] = dk_b.reshape(B, n, KV, rep, D).sum(3)
            out_[2][:, k0:k0 + n] = dv_b.reshape(B, n, KV, rep, Dv).sum(3)
    dq, dk, dv = grads
    res = ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
           dv.to(v.dtype))
    if not with_terms:
        return res
    return res, (terms[0] * scale, terms[1] * scale, terms[2])


# The bf16 backward kernels against ``flash_attention_bwd_tc_mirror``.  Both
# compute in float32 from the same bf16 inputs and round each result once,
# so an element differs by two bf16 roundings (TC_BWD_RTOL of it) plus the
# float32 sums' order (TC_BWD_ATOL_OF_MAX of its tensor's largest
# magnitude).  They also compute each P and dS in float32 in another order
# (wgmma's sums, ex2.approx), so a P or dS at a bf16 rounding boundary may
# round to the neighbouring value in one of them, moving its term by one
# bf16 ulp of it.  Where the terms cancel (dq's: each row of dS sums to
# zero) that is many ulps of a small result, so the few elements a tensor
# past two roundings (at most TC_BWD_MAX_PAST) are held to one bf16
# rounding of the tensor's largest magnitude (TC_BWD_PAST_OF_MAX of it).
# A kernel that drops or doubles a tile of queries or keys moves thousands
# of elements and fails.
TC_BWD_ATOL_OF_MAX = 1e-4
TC_BWD_RTOL = 2 ** -7
TC_BWD_MAX_PAST = 64
TC_BWD_PAST_OF_MAX = 2 ** -7


def tc_bwd_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How a bf16 backward gradient ``got`` agrees with the mirror's
    ``want``: the max abs difference, the elements past two roundings, the
    largest of their differences as a fraction of the tensor's largest
    magnitude, and ``ok``: whether that is within the gate above."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    if diff.numel() == 0:
        return dict(max_abs_err=0.0, past_two_roundings=0, past_of_max=0.0,
                    ok=True)
    big = float(b.abs().max())
    atol = TC_BWD_ATOL_OF_MAX * big
    past = diff > atol + TC_BWD_RTOL * b.abs()
    n_past = int(past.sum())
    worst = float(diff[past].max()) / big if n_past else 0.0
    return dict(max_abs_err=float(diff.max()), past_two_roundings=n_past,
                past_of_max=worst,
                ok=n_past <= TC_BWD_MAX_PAST
                and bool((diff <= atol + TC_BWD_PAST_OF_MAX * big).all()))
