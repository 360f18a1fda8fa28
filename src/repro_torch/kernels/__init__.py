"""Hand-written Hopper kernels of the port, one folder per TPU kernel of
the reference (``<name>/csrc/*.cu`` + ``ops.py`` wrapper + ``ref.py`` plain
PyTorch version + ``cost.py`` the work of one call).

Every kernel launch is a PyTorch operator of the ``repro_torch`` namespace
(``define``), registered once, when its ``ops`` module is imported, with
three implementations chosen by the dispatcher from the tensors' device:
``CUDA``, the kernel's ``ctypes`` launch (counted in the wrapper's launch
counter); ``CPU``, its plain version; and a fake one, which gives only the
shapes and dtypes of the outputs, so that a trace on fake tensors
(``launch.graph_analysis``) sees the operator, launches nothing and counts
the kernel's work by its ``cost.py``."""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Register the operator ``schema`` ("name(args) -> returns") with its
    CPU, CUDA and fake implementations; returns its overload, which the
    wrapper calls (the dispatcher's shortest path from Python)."""
    name = schema.split("(", 1)[0]

    def traced(*args):
        """The fake implementation, for fake tensors only: a bare meta
        tensor is refused as any other device the kernels do not take."""
        for a in args:
            if isinstance(a, torch.Tensor) and not is_fake(a):
                raise ValueError(f"{name}: unsupported device {a.device}")
        return fake(*args)

    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", traced, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
