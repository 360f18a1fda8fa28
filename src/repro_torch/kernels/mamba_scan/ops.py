"""``selective_scan``: the wrapper of the Hopper Mamba-1 scan kernel.

A CPU tensor goes to the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the kernel (``csrc/mamba_scan.cu``, built at first use and loaded
with ``ctypes``) or raises: there is no fallback.  The wrapper checks
device, dtype (float32 only, as the reference scan runs), shapes and
contiguity and raises on anything the kernel does not take (state size up
to 32).  ``selective_scan.launches`` counts kernel launches (and nothing
else), so a run can show that it went through the kernel.  ``split``
reports how the kernel divides a shape over the card.

Gradients: when autograd records (grad enabled and an input requiring
grad), ``selective_scan`` runs as ``SelectiveScanFn``: the forward saves
its inputs, and the backward is ``selective_scan_bwd`` — on the card the
kernels of ``csrc/mamba_scan_bwd.cu`` (a reverse-time scan and the three
fixed-order sums of its partials, four launches, each counted in
``selective_scan.launches_bwd``), on the CPU ``ref.selective_scan_bwd_ref``
— giving du, ddelta, dA, dB, dC and dh0 from the gradients of y and h_T.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .ref import selective_scan_bwd_ref, selective_scan_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "mamba_scan.cu", CSRC / "mamba_scan_bwd.cu")
MAX_STATE = 32
BWD_LAUNCHES = 4  # kernels a selective_scan_bwd call launches


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
    lib.mamba_selective_scan_bwd.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_selective_scan_bwd.restype = ctypes.c_int
    lib.mamba_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4
    lib.mamba_scan_bwd_scratch.restype = ctypes.c_longlong
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


def _check_card(names, args):
    """The checks of a CUDA call: one device, float32, contiguous, the
    kernel's state sizes.  Returns the device."""
    devices = {x.device for x in args}
    if len(devices) != 1:
        raise ValueError(f"selective_scan: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    for name, x in zip(names, args):
        if x.dtype != torch.float32:
            raise ValueError(f"selective_scan: {name} must be float32, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    Ds = args[2].shape[1]
    if not 1 <= Ds <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {Ds} outside "
                         f"1..{MAX_STATE}")
    return dev


def _forward(u, delta, A, Bc, Cc, h0):
    args = [u, delta, A, Bc, Cc] + ([] if h0 is None else [h0])
    if {x.device for x in args} == {torch.device("cpu")}:
        return selective_scan_ref(u, delta, A, Bc, Cc, h0)
    dev = _check_card(("u", "delta", "A", "Bc", "Cc", "h0"), args)
    B, S, Di = u.shape
    Ds = A.shape[1]
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


def selective_scan_bwd(u, delta, A, Bc, Cc, h0, dy, dhT=None):
    """(du, ddelta, dA, dB, dC, dh0) of ``selective_scan(u, delta, A, Bc,
    Cc, h0)`` for the gradients ``dy`` of y and ``dhT`` of h_T (None:
    zeros); dh0 is None without h0.  The plain version on the CPU, the
    backward kernel on the card (counted in
    ``selective_scan.launches_bwd``)."""
    _check_shapes(u, delta, A, Bc, Cc, h0)
    B, S, Di = u.shape
    Ds = A.shape[1]
    if tuple(dy.shape) != (B, S, Di) or (
            dhT is not None and tuple(dhT.shape) != (B, Di, Ds)):
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} or dhT "
                         f"{None if dhT is None else tuple(dhT.shape)} do "
                         f"not match {(B, S, Di)}, {(B, Di, Ds)}")
    given = [(n, x) for n, x in (("u", u), ("delta", delta), ("A", A),
                                 ("Bc", Bc), ("Cc", Cc), ("dy", dy),
                                 ("h0", h0), ("dhT", dhT)) if x is not None]
    if {x.device for _, x in given} == {torch.device("cpu")}:
        return selective_scan_bwd_ref(u, delta, A, Bc, Cc, h0, dy, dhT)
    dev = _check_card(*zip(*given))
    du, ddelta = (torch.empty((B, S, Di), dtype=torch.float32, device=dev)
                  for _ in range(2))
    dB, dC = (torch.empty((B, S, Ds), dtype=torch.float32, device=dev)
              for _ in range(2))
    dA = torch.zeros((Di, Ds), dtype=torch.float32, device=dev)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if S == 0 or B == 0 or Di == 0:
        if dh0 is not None:      # with S = 0, h_T is h0
            dh0.copy_(dhT) if dhT is not None else dh0.zero_()
        return du, ddelta, dA, dB, dC, dh0
    lib = _lib()
    scratch = torch.empty(lib.mamba_scan_bwd_scratch(B, S, Di, Ds),
                          dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    with on(dev):
        rc = lib.mamba_selective_scan_bwd(
            *(ptr(x) for x in (u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta,
                               dA, dB, dC, dh0, scratch)),
            B, S, Di, Ds, stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"mamba_scan backward kernel launch failed: CUDA "
                           f"error {rc}")
    # the reverse-time scan, then the sums of dA's, dB's and dC's partials
    count(selective_scan, "launches_bwd", launches=BWD_LAUNCHES)
    return du, ddelta, dA, dB, dC, dh0


class SelectiveScanFn(torch.autograd.Function):
    """The scan that autograd differentiates with ``selective_scan_bwd``:
    the forward saves its inputs, the backward recomputes the states."""

    @staticmethod
    def forward(ctx, u, delta, A, Bc, Cc, h0):
        y, hT = _forward(u, delta, A, Bc, Cc, h0)
        ctx.save_for_backward(u, delta, A, Bc, Cc, h0)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        u, delta, A, Bc, Cc, h0 = ctx.saved_tensors
        return selective_scan_bwd(u, delta, A, Bc, Cc, h0, dy.contiguous(),
                                  dhT.contiguous())


def selective_scan(u, delta, A, Bc, Cc, h0=None):
    """u/delta (B, S, Di); A (Di, Ds); Bc/Cc (B, S, Ds); h0 (B, Di, Ds) or
    None -> (y (B, S, Di), h_T (B, Di, Ds)), float32.  Differentiable
    (``SelectiveScanFn``) when autograd records."""
    _check_shapes(u, delta, A, Bc, Cc, h0)
    args = [u, delta, A, Bc, Cc] + ([] if h0 is None else [h0])
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return SelectiveScanFn.apply(u, delta, A, Bc, Cc, h0)
    return _forward(u, delta, A, Bc, Cc, h0)


selective_scan.launches = 0
selective_scan.launches_bwd = 0
