"""``flash_attention``: the wrapper of the Hopper flash-attention kernel.

A CPU tensor goes to the plain PyTorch version (``ref.flash_attention_blocked``).
A CUDA tensor launches a kernel (``csrc/``, built at first use into one
library and loaded with ``ctypes``) or raises: there is no fallback.
bfloat16 runs the tensor-core kernel (``csrc/flash_attention_wgmma.cu``),
float32 the SIMT kernel (``csrc/flash_attention.cu``).  The wrapper checks
device, dtype, rank, shapes and contiguity and raises on anything the
kernels do not take (float32 or bfloat16 only, one type for q, k and v,
D up to 192 and Dv up to 128 — MLA's 128 + 64 query/key dims over 128
value dims; for bfloat16 head dims that are multiples of 8 and 16-byte
aligned pointers).  ``flash_attention.launches`` counts kernel
launches (and nothing else) and ``flash_attention.launches_tc`` the
bfloat16 tensor-core launches among them, so a run can show which kernel
served it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .ref import MASK_KINDS, flash_attention_blocked

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "flash_attention.cu", CSRC / "flash_attention_wgmma.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 192       # q/k head dim
MAX_DV = 128      # v/out head dim


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("flash_attention", SOURCES)


@library_loader("flash_attention")
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_kind: str = "causal", window: int = 0,
                    kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k (B, Sk, KV, D); v (B, Sk, KV, Dv) -> (B, Sq, H,
    Dv) in q's dtype: masked online-softmax attention, float32 inside."""
    _check_shapes(q, k, v, mask_kind, kv_valid_len)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_blocked(q, k, v, mask_kind, window,
                                       kv_valid_len)
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
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if not (1 <= D <= MAX_D and 1 <= Dv <= MAX_DV):
        raise ValueError(f"flash_attention: head dims ({D}, {Dv}) outside "
                         f"D 1..{MAX_D}, Dv 1..{MAX_DV}")
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores and (D % 8 or Dv % 8):
        raise ValueError(f"flash_attention: bfloat16 head dims ({D}, {Dv}) "
                         f"must be multiples of 8")
    if tensor_cores and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k, v must start on "
                         "16-byte boundaries")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    valid_len = Sk if kv_valid_len is None else int(kv_valid_len)
    q_offset = 0 if kv_valid_len is None else valid_len - Sq
    fn = _lib()
    with on(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], B, Sq, Sk, H, KV, D, Dv,
                MASK_KINDS.index(mask_kind), int(window), valid_len,
                q_offset, stream_of(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    count(flash_attention, "launches",
          *(("launches_tc",) if tensor_cores else ()))
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
