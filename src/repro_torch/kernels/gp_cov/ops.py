"""``matern52``: the wrapper of the Hopper Matérn-5/2 covariance kernel.

A CPU tensor goes to the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the kernel (``csrc/gp_cov.cu``, built at first use and loaded with
``ctypes``) or raises: there is no fallback.  The wrapper checks device,
dtype, shape and contiguity and raises on anything the kernel does not
take.  The lengthscale is a launch argument, so one library serves every
value.  ``matern52.launches`` counts kernel launches (and nothing else), so
a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import torch

from ..build import build_library
from ..launch import on, stream_of
from .ref import matern52_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "gp_cov.cu",)


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("gp_cov", SOURCES)


@lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.gp_cov_matern52
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matern52(X1: torch.Tensor, X2: torch.Tensor,
             lengthscale: float = 0.3) -> torch.Tensor:
    """K (n, m) float32: the Matérn-5/2 covariance of the rows of ``X1``
    (n, d) against the rows of ``X2`` (m, d), from direct differences."""
    if X1.device.type == "cpu" and X2.device.type == "cpu":
        return matern52_ref(X1, X2, lengthscale)
    if X1.device != X2.device:
        raise ValueError(f"matern52: X1 and X2 lie on different devices "
                         f"({X1.device}, {X2.device})")
    if X1.device.type != "cuda":
        raise ValueError(f"matern52: unsupported device {X1.device}")
    for name, x in (("X1", X1), ("X2", X2)):
        if x.dim() != 2 or x.dtype != torch.float32:
            raise ValueError(f"matern52: {name} must be 2-D float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"matern52: {name} must be contiguous")
    (n, d), (m, d2) = X1.shape, X2.shape
    if d != d2:
        raise ValueError(f"matern52: X1 has {d} features, X2 has {d2}")
    out = torch.empty((n, m), dtype=torch.float32, device=X1.device)
    if n == 0 or m == 0:
        return out
    fn = _lib()
    with on(X1.device):
        rc = fn(X1.data_ptr(), X2.data_ptr(), out.data_ptr(), n, m, d,
                float(lengthscale), stream_of(X1.device))
    if rc != 0:
        raise RuntimeError(f"gp_cov kernel launch failed: CUDA error {rc}")
    matern52.launches += 1
    return out


matern52.launches = 0
