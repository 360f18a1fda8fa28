"""``dominance_counts``: the wrapper of the Hopper dominance-count kernel.

A CPU tensor goes to the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the kernel (``csrc/pareto_rank.cu``, built at first use and loaded
with ``ctypes``) for every pool size, or raises: there is no fallback.  The
wrapper checks device, dtype, shape and contiguity and raises on anything
the kernel does not take.  ``dominance_counts.launches`` counts kernel
launches (and nothing else), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import torch

from ..build import build_library
from ..launch import on, stream_of
from .ref import dominance_counts_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "pareto_rank.cu",)
MAX_K = 4


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("pareto_rank", SOURCES)


@lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.pareto_rank_dominance_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dominance_counts(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n,) int32 number of *valid* rows dominating each row of ``objs``
    (n, k), all objectives minimized.  Zero => nondominated."""
    if objs.device.type == "cpu":
        return dominance_counts_ref(objs, valid)
    if objs.device.type != "cuda":
        raise ValueError(f"dominance_counts: unsupported device "
                         f"{objs.device}")
    if objs.dim() != 2 or objs.dtype != torch.float32:
        raise ValueError(f"dominance_counts: objs must be (n, k) float32, "
                         f"got {tuple(objs.shape)} {objs.dtype}")
    n, k = objs.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"dominance_counts: the kernel takes 1..{MAX_K} "
                         f"objectives, got {k}")
    if valid.shape != (n,) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"dominance_counts: valid must be ({n},) bool or "
                         f"uint8, got {tuple(valid.shape)} {valid.dtype}")
    if valid.device != objs.device:
        raise ValueError("dominance_counts: objs and valid lie on different "
                         "devices")
    if not (objs.is_contiguous() and valid.is_contiguous()):
        raise ValueError("dominance_counts: objs and valid must be "
                         "contiguous")
    out = torch.empty(n, dtype=torch.int32, device=objs.device)
    if n == 0:
        return out
    fn = _lib()
    with on(objs.device):
        rc = fn(objs.data_ptr(), valid.data_ptr(), out.data_ptr(), n, k,
                stream_of(objs.device))
    if rc != 0:
        raise RuntimeError(f"pareto_rank kernel launch failed: CUDA error "
                           f"{rc}")
    dominance_counts.launches += 1
    return out


dominance_counts.launches = 0
