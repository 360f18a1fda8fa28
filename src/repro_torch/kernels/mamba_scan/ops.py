"""``selective_scan``: the wrapper of the Hopper Mamba-1 scan kernel.

A CPU tensor goes to the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the kernel (``csrc/mamba_scan.cu``, built at first use and loaded
with ``ctypes``) or raises: there is no fallback.  The wrapper checks
device, dtype (float32 only, as the reference scan runs), shapes and
contiguity and raises on anything the kernel does not take (state size up
to 32).  ``selective_scan.launches`` counts kernel launches (and nothing
else), so a run can show that it went through the kernel.  ``split``
reports how the kernel divides a shape over the card.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .ref import selective_scan_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu",)
MAX_STATE = 32


def build() -> Path:
    """Compile the kernel (if not yet built) and return the library path."""
    return build_library("mamba_scan", SOURCES)


@library_loader("mamba_scan")
def _lib():
    lib = ctypes.CDLL(str(build()))
    lib.mamba_selective_scan.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_selective_scan.restype = ctypes.c_int
    lib.mamba_scan_split.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mamba_scan_split.restype = ctypes.c_int
    return lib


def split(B: int, Di: int, Ds: int) -> dict:
    """How the kernel splits a (B, ., Di) scan with state size Ds over the
    card: threads a channel (G), states a thread, threads and blocks of
    the launch, and blocks one SM can hold at once."""
    out = (ctypes.c_int * 5)()
    rc = _lib().mamba_scan_split(B, Di, Ds, out)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_split failed: CUDA error {rc}")
    keys = ("threads_per_channel", "states_per_thread", "threads_per_block",
            "blocks", "blocks_per_sm_max_resident")
    return dict(zip(keys, out))


def _check_shapes(u, delta, A, Bc, Cc, h0):
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: u must be (B, S, Di) and A (Di, "
                         f"Ds), got {tuple(u.shape)}, {tuple(A.shape)}")
    B, S, Di = u.shape
    Ds = A.shape[1]
    want = {"delta": (delta, (B, S, Di)), "A": (A, (Di, Ds)),
            "Bc": (Bc, (B, S, Ds)), "Cc": (Cc, (B, S, Ds))}
    if h0 is not None:
        want["h0"] = (h0, (B, Di, Ds))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")


def selective_scan(u, delta, A, Bc, Cc, h0=None):
    """u/delta (B, S, Di); A (Di, Ds); Bc/Cc (B, S, Ds); h0 (B, Di, Ds) or
    None -> (y (B, S, Di), h_T (B, Di, Ds)), float32."""
    _check_shapes(u, delta, A, Bc, Cc, h0)
    args = [u, delta, A, Bc, Cc] + ([] if h0 is None else [h0])
    devices = {x.device for x in args}
    if devices == {torch.device("cpu")}:
        return selective_scan_ref(u, delta, A, Bc, Cc, h0)
    if len(devices) != 1:
        raise ValueError(f"selective_scan: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    names = ("u", "delta", "A", "Bc", "Cc", "h0")
    for name, x in zip(names, args):
        if x.dtype != torch.float32:
            raise ValueError(f"selective_scan: {name} must be float32, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    B, S, Di = u.shape
    Ds = A.shape[1]
    if not 1 <= Ds <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {Ds} outside "
                         f"1..{MAX_STATE}")
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dev)
    hT = torch.empty((B, Di, Ds), dtype=torch.float32, device=dev)
    if hT.numel() == 0:
        return y, hT
    fn = _lib().mamba_selective_scan
    with on(dev):
        rc = fn(u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                Cc.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), hT.data_ptr(), B, S, Di, Ds, stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    count(selective_scan, "launches")
    return y, hT


selective_scan.launches = 0
