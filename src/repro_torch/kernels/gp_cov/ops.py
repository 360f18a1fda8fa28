"""``matern52``: the wrapper of the Hopper Matérn-5/2 covariance kernel.

The call is the operator ``repro_torch::matern52`` (``OP``; see
``kernels.define``): a CPU tensor goes to the plain PyTorch version
(``ref.py``), a CUDA tensor launches the kernel (``csrc/gp_cov.cu``, built
at first use and loaded with ``ctypes``) or raises: there is no fallback;
a fake tensor gets the output's shape.  The wrapper checks device,
dtype, shape and contiguity and raises on anything the kernel does not
take.  The lengthscale is a launch argument, so one library serves every
value.  ``matern52.launches`` counts kernel launches (and nothing else), so
a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import define
from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .ref import matern52_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "gp_cov.cu",)


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("gp_cov", SOURCES)


@library_loader("gp_cov")
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.gp_cov_matern52
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(X1: torch.Tensor, X2: torch.Tensor,
            lengthscale: float) -> torch.Tensor:
    """The CUDA implementation of ``repro_torch::matern52``: the checks of
    the kernel, then its launch."""
    if X1.device != X2.device:
        raise ValueError(f"matern52: X1 and X2 lie on different devices "
                         f"({X1.device}, {X2.device})")
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
    count(matern52, "launches")
    return out


def _fake(X1, X2, lengthscale):
    return X1.new_empty((X1.shape[0], X2.shape[0]), dtype=torch.float32)


def _plain(X1, X2, lengthscale):
    return matern52_ref(X1, X2, lengthscale)


OP = define("matern52(Tensor X1, Tensor X2, float lengthscale) -> Tensor",
            _plain, _launch, _fake)


def matern52(X1: torch.Tensor, X2: torch.Tensor,
             lengthscale: float = 0.3) -> torch.Tensor:
    """K (n, m) float32: the Matérn-5/2 covariance of the rows of ``X1``
    (n, d) against the rows of ``X2`` (m, d), from direct differences."""
    return OP(X1, X2, float(lengthscale))


matern52.launches = 0
