"""``flash_attention``: the wrapper of the Hopper flash-attention kernels.

A CPU tensor goes to the plain PyTorch version (``ref.flash_attention_blocked``).
A CUDA tensor launches a kernel (``csrc/``, built at first use into one
library and loaded with ``ctypes``) or raises: there is no fallback.
Both dtypes run on tensor cores: bfloat16 the wgmma kernel of
``csrc/flash_attention_wgmma.cu``, float32 the 3xTF32 wgmma kernels of
``csrc/flash_attention_tf32.cu`` (each float32 product as three TF32
products of the operands' high and low parts, within the 2e-5 float32
tolerance; a key-split kernel, one launch, serves the calls whose KV head
has at most 8 query rows, Sq * H / KV, such as every decode step).  The
wrapper checks device, dtype, rank, shapes and contiguity and raises on
anything the kernels do not take (float32 or bfloat16 only, one type for
q, k and v, D up to 192 and Dv up to 128 — MLA's 128 + 64 query/key dims
over 128 value dims; for bfloat16 head dims that are multiples of 8 and
16-byte aligned pointers).  ``flash_attention.launches`` counts forward
kernel launches (and nothing else) and ``flash_attention.launches_tc`` the
tensor-core launches among them, of both dtypes (every forward launch),
so a run can show which kernel served it.

Gradients: when autograd records (grad enabled and q, k or v requiring
grad), ``flash_attention`` runs as ``FlashAttentionFn``, the counterpart of
the reference's custom VJP ``_fa_diff``: the forward also writes each
row's log-sum-exp and saves (q, k, v, out, lse); the backward is
``flash_attention_bwd`` — on the card three launches, or two when Sk is 0,
each counted in ``flash_attention.launches_bwd``: the delta kernel of
``csrc/flash_attention_bwd.cu``, then the tensor-core dk / dv and dq
kernels, for bfloat16 of ``csrc/flash_attention_bwd_wgmma.cu`` and for
float32 (3xTF32) of ``csrc/flash_attention_bwd_tf32.cu``; on the CPU
``ref.flash_attention_bwd_blocked``.  Without autograd nothing is saved
and the forward writes no log-sum-exp, so serving is unchanged.
``bwd_occupancy`` reports the bfloat16 backward kernels' launch shape.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .ref import (MASK_KINDS, flash_attention_blocked,
                  flash_attention_bwd_blocked)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "flash_attention.cu", CSRC / "flash_attention_wgmma.cu",
           CSRC / "flash_attention_tf32.cu", CSRC / "flash_attention_bwd.cu",
           CSRC / "flash_attention_bwd_wgmma.cu",
           CSRC / "flash_attention_bwd_tf32.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 192       # q/k head dim
MAX_DV = 128      # v/out head dim
BWD_LAUNCHES = 3  # kernels a flash_attention_bwd call launches


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("flash_attention", SOURCES)


@library_loader("flash_attention")
def _lib():
    lib = ctypes.CDLL(str(build()))
    fwd = lib.flash_attention_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                    + [ctypes.c_void_p])
    fwd_lse = lib.flash_attention_fwd_lse
    fwd_lse.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                        + [ctypes.c_void_p])
    bwd = lib.flash_attention_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                    + [ctypes.c_void_p])
    occ = lib.flash_attention_bwd_occupancy
    occ.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    probe = lib.flash_attention_tf32_probe
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    for fn in (fwd, fwd_lse, bwd, occ, probe):
        fn.restype = ctypes.c_int
    return lib


def bwd_occupancy(D: int, Dv: int) -> dict:
    """The bfloat16 backward kernels' launch shape for head dims (D, Dv):
    threads a block, dynamic shared memory and the blocks one SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), for the dk /
    dv kernel and the dq kernel."""
    out = (ctypes.c_int * 6)()
    rc = _lib().flash_attention_bwd_occupancy(D, Dv, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_occupancy failed: CUDA "
                           f"error {rc}")
    keys = ("threads", "smem_bytes", "blocks_per_sm")
    return {"dkdv": dict(zip(keys, out[:3])), "dq": dict(zip(keys, out[3:]))}


def tf32_probe(a: torch.Tensor, b: torch.Tensor,
               products: int = 3) -> torch.Tensor:
    """c = a b^T (64 x 64, float32) on the card from a and b (64, D)
    float32, D 64, 128 or 192, computed as the float32 kernels compute S =
    Q K^T (``products=3``: 3xTF32 on wgmma; 1: one TF32 product of the
    high parts): a measurement of the tensor cores' arithmetic against a
    float64 product, on no path of the port."""
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != 64 or \
            a.shape[1] not in (64, 128, 192):
        raise ValueError(f"tf32_probe: a and b must be (64, 64 | 128 | "
                         f"192), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device.type != "cuda" or b.device != a.device or \
            a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("tf32_probe: a and b must be float32 on one card")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    with on(a.device):
        rc = _lib().flash_attention_tf32_probe(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), a.shape[1], products,
            stream_of(a.device))
    if rc != 0:
        raise RuntimeError(f"tf32_probe launch failed: CUDA error {rc}")
    return c


def _check_shapes(q, k, v, mask_kind: str, kv_valid_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match (B, Sk, KV, D | Dv)")
    KV = k.shape[2]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"flash_attention: unknown mask kind {mask_kind!r}")
    if kv_valid_len is not None and not 0 <= int(kv_valid_len) <= k.shape[1]:
        raise ValueError(f"flash_attention: kv_valid_len {kv_valid_len} "
                         f"outside [0, {k.shape[1]}]")


def _check_card(q, k, v, *more):
    """The checks of a CUDA call: one device, one supported dtype,
    contiguous tensors, the kernels' head dims."""
    devices = {x.device for x in (q, k, v, *more)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: q, k, v lie on different devices "
                         f"{sorted(map(str, devices))}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    D, Dv = q.shape[3], v.shape[3]
    if not (1 <= D <= MAX_D and 1 <= Dv <= MAX_DV):
        raise ValueError(f"flash_attention: head dims ({D}, {Dv}) outside "
                         f"D 1..{MAX_D}, Dv 1..{MAX_DV}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (D % 8 or Dv % 8):
        raise ValueError(f"flash_attention: bfloat16 head dims ({D}, {Dv}) "
                         f"must be multiples of 8")
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k, v must start on "
                         "16-byte boundaries")


def _mask_args(q, k, mask_kind: str, window: int, kv_valid_len):
    """(mask kind index, window, valid_len, q_offset) of the C entries."""
    Sk = k.shape[1]
    valid_len = Sk if kv_valid_len is None else int(kv_valid_len)
    q_offset = 0 if kv_valid_len is None else valid_len - q.shape[1]
    return MASK_KINDS.index(mask_kind), int(window), valid_len, q_offset


def _forward(q, k, v, mask_kind: str, window: int, kv_valid_len,
             with_lse: bool):
    """Out (B, Sq, H, Dv), and with ``with_lse`` the rows' log-sum-exp (B,
    H, Sq) float32: the plain version on the CPU, a kernel on the card."""
    if {q.device, k.device, v.device} == {torch.device("cpu")}:
        return flash_attention_blocked(q, k, v, mask_kind, window,
                                       kv_valid_len, return_lse=with_lse)
    _check_card(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    lib = _lib()
    args = (DTYPES[q.dtype], B, Sq, Sk, H, KV, D, Dv,
            *_mask_args(q, k, mask_kind, window, kv_valid_len),
            stream_of(q.device))
    with on(q.device):
        if with_lse:
            rc = lib.flash_attention_fwd_lse(q.data_ptr(), k.data_ptr(),
                                             v.data_ptr(), out.data_ptr(),
                                             lse.data_ptr(), *args)
        else:
            rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                         v.data_ptr(), out.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    # one launch, on tensor cores for both dtypes
    count(flash_attention, "launches", "launches_tc")
    return (out, lse) if with_lse else out


def flash_attention_fwd_lse(q, k, v, mask_kind: str = "causal",
                            window: int = 0,
                            kv_valid_len: Optional[int] = None):
    """(out, lse): the forward and its rows' log-sum-exp (B, H, Sq) float32,
    the residuals the backward reads (what ``FlashAttentionFn`` saves)."""
    _check_shapes(q, k, v, mask_kind, kv_valid_len)
    return _forward(q, k, v, mask_kind, window, kv_valid_len, with_lse=True)


def flash_attention_bwd(q, k, v, out, lse, dout, mask_kind: str = "causal",
                        window: int = 0, kv_valid_len: Optional[int] = None):
    """(dq, dk, dv) in q's, k's and v's dtype from the forward's ``out`` and
    ``lse`` (B, H, Sq) float32 and the gradient ``dout`` of ``out``: the
    plain version on the CPU, the backward kernels on the card (counted in
    ``flash_attention.launches_bwd``)."""
    _check_shapes(q, k, v, mask_kind, kv_valid_len)
    if tuple(out.shape) != tuple(dout.shape) or out.shape[:3] != q.shape[:3] \
            or out.shape[3] != v.shape[3]:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must both be (B, Sq, H, "
                         f"Dv) of q {tuple(q.shape)}, v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: lse has shape "
                         f"{tuple(lse.shape)}, expected {(B, H, Sq)}")
    tensors = (q, k, v, out, lse, dout)
    if {x.device for x in tensors} == {torch.device("cpu")}:
        return flash_attention_bwd_blocked(q, k, v, out, lse, dout, mask_kind,
                                           window, kv_valid_len)
    _check_card(q, k, v, out, lse, dout)
    for name, x in (("out", out), ("dout", dout)):
        if x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous {q.dtype}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous "
                         "float32")
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if out.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with on(q.device):
        rc = _lib().flash_attention_bwd(
            *(x.data_ptr() for x in (q, k, v, out, lse, dout, dq, dk, dv,
                                     delta)),
            DTYPES[q.dtype], B, Sq, Sk, H, KV, D, Dv,
            *_mask_args(q, k, mask_kind, window, kv_valid_len),
            stream_of(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    # delta, dk / dv (not launched without keys) and dq
    count(flash_attention, "launches_bwd",
          launches=BWD_LAUNCHES if Sk > 0 else BWD_LAUNCHES - 1)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention that autograd differentiates with ``flash_attention_bwd``:
    the forward saves (q, k, v, out, lse), the backward recomputes P from
    lse (the reference's ``_fa_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kind, window, kv_valid_len):
        out, lse = _forward(q, k, v, mask_kind, window, kv_valid_len,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (mask_kind, window, kv_valid_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_kind: str = "causal", window: int = 0,
                    kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k (B, Sk, KV, D); v (B, Sk, KV, Dv) -> (B, Sq, H,
    Dv) in q's dtype: masked online-softmax attention, float32 inside.
    Differentiable (``FlashAttentionFn``) when autograd records."""
    _check_shapes(q, k, v, mask_kind, kv_valid_len)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, mask_kind, window,
                                      kv_valid_len)
    return _forward(q, k, v, mask_kind, window, kv_valid_len, with_lse=False)


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_bwd = 0
