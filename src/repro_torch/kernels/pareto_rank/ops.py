"""``dominance_counts``: the wrapper of the Hopper dominance-count kernel.

The call is the operator ``repro_torch::dominance_counts`` (``OP``; see
``kernels.define``): a CPU tensor goes to the plain PyTorch version
(``ref.py``), a CUDA tensor launches the kernel (``csrc/pareto_rank.cu``,
built at first use and loaded with ``ctypes``) for every pool size, or
raises: there is no fallback; a fake tensor gets the output's shape.
A pool is (n, k), or (L, n, k) for L lanes of one shape (a fused NSGA
run's problems): every lane goes in the same one launch.  The wrapper
checks device, dtype, shape and contiguity and raises on anything
the kernel does not take.  ``dominance_counts.launches`` counts kernel
launches (and nothing else), so a run can show that it went through the
kernel; ``dominance_counts.launches_lanes`` counts those of them that
ranked two or more lanes at once.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import define
from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .ref import dominance_counts_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "pareto_rank.cu",)
MAX_K = 4
MAX_LANES = 65535       # the grid's z extent


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("pareto_rank", SOURCES)


@library_loader("pareto_rank")
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.pareto_rank_dominance_counts_lanes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation of ``repro_torch::dominance_counts``: the
    checks of the kernel, then its launch."""
    if objs.dim() not in (2, 3) or objs.dtype != torch.float32:
        raise ValueError(f"dominance_counts: objs must be (n, k) or "
                         f"(L, n, k) float32, got {tuple(objs.shape)} "
                         f"{objs.dtype}")
    *lead, n, k = objs.shape
    lanes = lead[0] if lead else 1
    if not 1 <= k <= MAX_K:
        raise ValueError(f"dominance_counts: the kernel takes 1..{MAX_K} "
                         f"objectives, got {k}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"dominance_counts: the kernel takes 1..{MAX_LANES}"
                         f" lanes, got {lanes}")
    if (tuple(valid.shape) != (*lead, n)
            or valid.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"dominance_counts: valid must be "
                         f"{(*lead, n)} bool or uint8, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != objs.device:
        raise ValueError("dominance_counts: objs and valid lie on different "
                         "devices")
    if not (objs.is_contiguous() and valid.is_contiguous()):
        raise ValueError("dominance_counts: objs and valid must be "
                         "contiguous")
    out = torch.empty((*lead, n), dtype=torch.int32, device=objs.device)
    if n == 0 or lanes == 0:
        return out
    fn = _lib()
    with on(objs.device):
        rc = fn(objs.data_ptr(), valid.data_ptr(), out.data_ptr(), lanes, n,
                k, stream_of(objs.device))
    if rc != 0:
        raise RuntimeError(f"pareto_rank kernel launch failed: CUDA error "
                           f"{rc}")
    count(dominance_counts, "launches",
          *(("launches_lanes",) if lanes > 1 else ()))
    return out


def _plain(objs, valid):
    return dominance_counts_ref(objs, valid)


def _fake(objs, valid):
    return objs.new_empty(objs.shape[:-1], dtype=torch.int32)


OP = define("dominance_counts(Tensor objs, Tensor valid) -> Tensor",
            _plain, _launch, _fake)


def dominance_counts(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n,) int32 number of *valid* rows dominating each row of ``objs``
    (n, k), all objectives minimized.  Zero => nondominated.  With a
    leading lane axis, ``objs`` (L, n, k) and ``valid`` (L, n) give (L, n)
    counts, each lane ranked on its own, in one launch."""
    return OP(objs, valid)


dominance_counts.launches = 0
dominance_counts.launches_lanes = 0
