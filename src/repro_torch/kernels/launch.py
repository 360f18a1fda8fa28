"""What a kernel wrapper hands its ``ctypes`` call besides the tensors: the
raw ``cudaStream_t`` of the device's current stream, called under that
device.  Both are kept cheap: the search path calls its kernels on pools
of 64-768 rows, where the wrapper's Python is most of a call.  On an H100
host (``python -m repro_torch.kernels.ab wrapper``) the public
``torch.cuda.current_stream(dev).cuda_stream`` takes about 4 us a call,
building a ``Stream`` object, against about 0.2 us here; and entering
``torch.cuda.device`` on every call about 3 us, against about 0.9 us for
the check that skips it."""

from __future__ import annotations

import contextlib

import torch

_CURRENT = contextlib.nullcontext()


def stream_of(device: torch.device) -> int:
    """The raw current stream of the CUDA ``device``, an int for ctypes
    (the call PyTorch's own generated kernels make)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on(device: torch.device):
    """A context that makes the CUDA ``device`` current; one with nothing
    to do when it already is."""
    if device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)
