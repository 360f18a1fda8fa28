"""``selective_scan``: the wrapper of the Hopper Mamba-1 scan kernel.

Each call is an operator of ``kernels.define`` (``FWD``, ``FWD_STATES``,
``BWD``: ``repro_torch::selective_scan``, ``selective_scan_fwd_states``
and ``selective_scan_bwd``): a CPU tensor goes to the plain PyTorch
version (``ref.py``), a CUDA tensor launches the kernel
(``csrc/mamba_scan.cu``, built at first use and loaded with ``ctypes``) or
raises: there is no fallback; a fake tensor gets the outputs' shapes.
The wrapper checks device, dtype (float32 only, as the reference scan
runs), shapes and contiguity and raises on anything the kernel does not
take (state size up to 32).  ``selective_scan.launches`` counts kernel launches (and nothing
else), so a run can show that it went through the kernel.  ``split``
reports how the kernel divides a shape over the card.

Gradients: when autograd records (grad enabled and an input requiring
grad), ``selective_scan`` runs as ``SelectiveScanFn``: the forward also
writes the state at the start of every chunk of ``STATE_CHUNK`` steps and
saves them with its inputs, and the backward is ``selective_scan_bwd`` —
on the card the kernels of ``csrc/mamba_scan_bwd.cu`` (a reverse-time
scan from those states and the fixed-order sums of its partials, two
launches, each counted in ``selective_scan.launches_bwd``), on the CPU
``ref.selective_scan_bwd_ref`` — giving du, ddelta, dA, dB, dC and dh0
from the gradients of y and h_T.  Without autograd the forward writes no
states, so serving is unchanged.  ``bwd_split`` reports how the backward
divides a shape over the card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import define
from ..build import build_library, library_loader
from ..launch import count, on, stream_of
from .cost import BWD_LAUNCHES
from .ref import (STATE_CHUNK, n_state_chunks, selective_scan_bwd_ref,
                  selective_scan_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "mamba_scan.cu", CSRC / "mamba_scan_bwd.cu")
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
    lib.mamba_selective_scan_states.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_selective_scan_states.restype = ctypes.c_int
    lib.mamba_scan_bwd_split.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.mamba_scan_bwd_split.restype = ctypes.c_int
    lib.mamba_scan_split.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mamba_scan_split.restype = ctypes.c_int
    lib.mamba_selective_scan_bwd.argtypes = [ctypes.c_void_p] * 16 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_selective_scan_bwd.restype = ctypes.c_int
    lib.mamba_scan_state_chunk.argtypes = []
    lib.mamba_scan_state_chunk.restype = ctypes.c_int
    if lib.mamba_scan_state_chunk() != STATE_CHUNK:
        raise RuntimeError(f"mamba_scan: the kernels keep a state every "
                           f"{lib.mamba_scan_state_chunk()} steps, the plain "
                           f"versions every {STATE_CHUNK}")
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


@functools.lru_cache(maxsize=None)
def _bwd_plan(device: int, B: int, Di: int, Ds: int):
    """The backward's launch for (B, Di, Ds) on card ``device``, planned
    once (``mamba_scan_bwd_split``: occupancy queries and the kernel's
    shared-memory attribute) and handed to every launch of that shape."""
    out = (ctypes.c_int * 6)()
    with on(torch.device("cuda", device)):
        rc = _lib().mamba_scan_bwd_split(B, Di, Ds, out)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd_split failed: CUDA error {rc}")
    return out


def bwd_split(B: int, Di: int, Ds: int) -> dict:
    """How the backward kernel splits a (B, ., Di) scan with state size Ds
    over the current card: warps a block (chosen so that the busiest SM
    runs the fewest warps), blocks a batch row and in all, blocks one SM
    can hold at once, dynamic shared memory, threads a channel and states
    a thread."""
    keys = ("warps_per_block", "blocks_per_row", "blocks_per_sm_max_resident",
            "smem_bytes", "threads_per_channel", "states_per_thread")
    res = dict(zip(keys, _bwd_plan(torch.cuda.current_device(), B, Di, Ds)))
    res["blocks"] = B * res["blocks_per_row"]
    return res


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


def _launch_fwd(u, delta, A, Bc, Cc, h0, with_states: bool):
    """(y, h_T), and with ``with_states`` the states at the start of every
    chunk of ``STATE_CHUNK`` steps (B, ceil(S / STATE_CHUNK), Di, Ds), from
    the forward kernel: the CUDA implementation of
    ``repro_torch::selective_scan`` and ``selective_scan_fwd_states``."""
    args = [u, delta, A, Bc, Cc] + ([] if h0 is None else [h0])
    dev = _check_card(("u", "delta", "A", "Bc", "Cc", "h0"), args)
    B, S, Di = u.shape
    Ds = A.shape[1]
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dev)
    hT = torch.empty((B, Di, Ds), dtype=torch.float32, device=dev)
    states = (torch.empty((B, n_state_chunks(S), Di, Ds),
                          dtype=torch.float32, device=dev)
              if with_states else None)
    if hT.numel() == 0:
        return (y, hT, states) if with_states else (y, hT)
    lib = _lib()
    ptrs = (u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hT.data_ptr())
    with on(dev):
        if with_states:
            rc = lib.mamba_selective_scan_states(*ptrs, states.data_ptr(), B,
                                                 S, Di, Ds, stream_of(dev))
        else:
            rc = lib.mamba_selective_scan(*ptrs, B, S, Di, Ds,
                                          stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    count(selective_scan, "launches")
    return (y, hT, states) if with_states else (y, hT)


def _fresh(outs, inputs) -> tuple:
    """``outs`` with any tensor that is one of ``inputs`` copied (the plain
    versions hand back h0 or dhT itself for an empty sequence; an
    operator's outputs must not alias its inputs)."""
    return tuple(o.clone() if any(o is x for x in inputs) else o
                 for o in outs)


def _fake_fwd(u, delta, A, Bc, Cc, h0, with_states: bool):
    B, S, Di = u.shape
    Ds = A.shape[1]
    outs = (u.new_empty((B, S, Di), dtype=torch.float32),
            u.new_empty((B, Di, Ds), dtype=torch.float32))
    if with_states:
        outs += (u.new_empty((B, n_state_chunks(S), Di, Ds),
                             dtype=torch.float32),)
    return outs


SCAN_ARGS = ("Tensor u, Tensor delta, Tensor A, Tensor Bc, Tensor Cc, "
             "Tensor? h0")
FWD = define(
    f"selective_scan({SCAN_ARGS}) -> (Tensor, Tensor)",
    lambda u, d, A, Bc, Cc, h0: _fresh(
        selective_scan_ref(u, d, A, Bc, Cc, h0), (h0,)),
    lambda u, d, A, Bc, Cc, h0: _launch_fwd(u, d, A, Bc, Cc, h0, False),
    lambda u, d, A, Bc, Cc, h0: _fake_fwd(u, d, A, Bc, Cc, h0, False))
FWD_STATES = define(
    f"selective_scan_fwd_states({SCAN_ARGS}) -> (Tensor, Tensor, Tensor)",
    lambda u, d, A, Bc, Cc, h0: _fresh(selective_scan_ref(
        u, d, A, Bc, Cc, h0, return_states=True), (h0,)),
    lambda u, d, A, Bc, Cc, h0: _launch_fwd(u, d, A, Bc, Cc, h0, True),
    lambda u, d, A, Bc, Cc, h0: _fake_fwd(u, d, A, Bc, Cc, h0, True))


def selective_scan_fwd_states(u, delta, A, Bc, Cc, h0=None):
    """(y, h_T, states): the forward and its states at the start of every
    chunk of ``STATE_CHUNK`` steps (B, ceil(S / STATE_CHUNK), Di, Ds), the
    residuals the backward reads (what ``SelectiveScanFn`` saves)."""
    _check_shapes(u, delta, A, Bc, Cc, h0)
    return FWD_STATES(u, delta, A, Bc, Cc, h0)


def _launch_bwd(u, delta, A, Bc, Cc, h0, dy, dhT, states):
    """(du, ddelta, dA, dB, dC, dh0) from the backward kernels (dh0 empty
    without h0): the CUDA implementation of
    ``repro_torch::selective_scan_bwd``."""
    given = [(n, x) for n, x in (("u", u), ("delta", delta), ("A", A),
                                 ("Bc", Bc), ("Cc", Cc), ("dy", dy),
                                 ("h0", h0), ("dhT", dhT),
                                 ("states", states)) if x is not None]
    dev = _check_card(*zip(*given))
    B, S, Di = u.shape
    Ds = A.shape[1]
    du, ddelta = (torch.empty((B, S, Di), dtype=torch.float32, device=dev)
                  for _ in range(2))
    dB, dC = (torch.empty((B, S, Ds), dtype=torch.float32, device=dev)
              for _ in range(2))
    dA = torch.zeros((Di, Ds), dtype=torch.float32, device=dev)
    dh0 = (torch.empty((0,), dtype=torch.float32, device=dev) if h0 is None
           else torch.empty_like(h0))
    if S == 0 or B == 0 or Di == 0:
        if h0 is not None:       # with S = 0, h_T is h0
            dh0.copy_(dhT) if dhT is not None else dh0.zero_()
        return du, ddelta, dA, dB, dC, dh0
    if states is None:
        states = FWD_STATES(u, delta, A, Bc, Cc, h0)[2]
    plan = _bwd_plan(dev.index, B, Di, Ds)
    # dA's partials a batch row, dB's and dC's a block of channels
    scratch = torch.empty(B * Di * Ds + B * S * plan[1] * 2 * Ds,
                          dtype=torch.float32, device=dev)
    with on(dev):
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = _lib().mamba_selective_scan_bwd(
            *(ptr(x) for x in (u, delta, A, Bc, Cc, states, dy, dhT, du,
                               ddelta, dA, dB, dC,
                               None if h0 is None else dh0)),
            ctypes.addressof(plan), scratch.data_ptr(), B, S, Di, Ds,
            stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"mamba_scan backward kernel launch failed: CUDA "
                           f"error {rc}")
    # the reverse-time scan, then the sums of its partials
    count(selective_scan, "launches_bwd", launches=BWD_LAUNCHES)
    return du, ddelta, dA, dB, dC, dh0


def _plain_bwd(u, delta, A, Bc, Cc, h0, dy, dhT, states):
    *grads, dh0 = selective_scan_bwd_ref(u, delta, A, Bc, Cc, h0, dy, dhT,
                                         states)
    if dh0 is None:
        dh0 = u.new_empty((0,), dtype=torch.float32)
    return _fresh((*grads, dh0), (dhT,))


def _fake_bwd(u, delta, A, Bc, Cc, h0, dy, dhT, states):
    B, S, Di = u.shape
    Ds = A.shape[1]
    f32 = dict(dtype=torch.float32)
    return (u.new_empty((B, S, Di), **f32), u.new_empty((B, S, Di), **f32),
            u.new_empty((Di, Ds), **f32), u.new_empty((B, S, Ds), **f32),
            u.new_empty((B, S, Ds), **f32),
            u.new_empty((0,) if h0 is None else (B, Di, Ds), **f32))


BWD = define(
    f"selective_scan_bwd({SCAN_ARGS}, Tensor dy, Tensor? dhT, "
    f"Tensor? states) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _plain_bwd, _launch_bwd, _fake_bwd)


def selective_scan_bwd(u, delta, A, Bc, Cc, h0, dy, dhT=None, states=None):
    """(du, ddelta, dA, dB, dC, dh0) of ``selective_scan(u, delta, A, Bc,
    Cc, h0)`` for the gradients ``dy`` of y and ``dhT`` of h_T (None:
    zeros); dh0 is None without h0.  ``states``: the forward's states at
    the start of every chunk of ``STATE_CHUNK`` steps, (B, ceil(S /
    STATE_CHUNK), Di, Ds) (what ``SelectiveScanFn`` saves); None runs the
    forward for them (on the card one more ``selective_scan.launches``).
    The plain version on the CPU, the backward kernels on the card
    (counted in ``selective_scan.launches_bwd``)."""
    _check_shapes(u, delta, A, Bc, Cc, h0)
    B, S, Di = u.shape
    Ds = A.shape[1]
    if tuple(dy.shape) != (B, S, Di) or (
            dhT is not None and tuple(dhT.shape) != (B, Di, Ds)):
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} or dhT "
                         f"{None if dhT is None else tuple(dhT.shape)} do "
                         f"not match {(B, S, Di)}, {(B, Di, Ds)}")
    if states is not None and tuple(states.shape) != (
            B, n_state_chunks(S), Di, Ds):
        raise ValueError(f"selective_scan_bwd: states have shape "
                         f"{tuple(states.shape)}, expected "
                         f"{(B, n_state_chunks(S), Di, Ds)}")
    *grads, dh0 = BWD(u, delta, A, Bc, Cc, h0, dy, dhT, states)
    return (*grads, None if h0 is None else dh0)


class SelectiveScanFn(torch.autograd.Function):
    """The scan that autograd differentiates with ``selective_scan_bwd``:
    the forward saves its inputs and its states at the start of every
    chunk of ``STATE_CHUNK`` steps, the backward recomputes the others."""

    @staticmethod
    def forward(ctx, u, delta, A, Bc, Cc, h0):
        y, hT, states = FWD_STATES(u, delta, A, Bc, Cc, h0)
        ctx.save_for_backward(u, delta, A, Bc, Cc, h0, states)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        u, delta, A, Bc, Cc, h0, states = ctx.saved_tensors
        *grads, dh0 = BWD(u, delta, A, Bc, Cc, h0, dy.contiguous(),
                          dhT.contiguous(), states)
        return (*grads, None if h0 is None else dh0)


def selective_scan(u, delta, A, Bc, Cc, h0=None):
    """u/delta (B, S, Di); A (Di, Ds); Bc/Cc (B, S, Ds); h0 (B, Di, Ds) or
    None -> (y (B, S, Di), h_T (B, Di, Ds)), float32.  Differentiable
    (``SelectiveScanFn``) when autograd records."""
    _check_shapes(u, delta, A, Bc, Cc, h0)
    args = [u, delta, A, Bc, Cc] + ([] if h0 is None else [h0])
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return SelectiveScanFn.apply(u, delta, A, Bc, Cc, h0)
    return FWD(u, delta, A, Bc, Cc, h0)


selective_scan.launches = 0
selective_scan.launches_bwd = 0
