"""Device and random-stream conventions shared by every entry point.

* ``resolve_device`` — every entry point takes ``device=`` and defaults to
  ``"cuda"``.  Without a card it raises unless the caller asked for the CPU:
  the port never falls back to the CPU on its own.
* ``fold_in`` / ``generator`` — the port's stand-in for ``jax.random`` key
  chains: integer seeds derived by hashing (the analogue of
  ``jax.random.fold_in``), each turned into a ``torch.Generator`` on the
  device that consumes it.  Streams differ from JAX's, so parity tests feed
  both packages the same numpy inputs instead of the same seeds.
* ``LaneGenerators`` / ``rand`` — the random draws of a fused run: L
  problems evolve as lanes of one population, each drawing from its own
  generator exactly what its unfused run draws.

The training runtime lives beside them: ``driver`` (the fault-tolerant
trainer) and ``straggler`` (the step-time monitor).
"""

from __future__ import annotations

import hashlib

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on.  Raises when CUDA is
    asked for (the default) and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        # float32 products stay float32 on the card (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         f"'cpu'")
    return dev


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed derived from ``seed`` and ``data`` — distinct
    ``data`` give independent streams (the ``jax.random.fold_in`` idiom)."""
    h = hashlib.sha256(f"{int(seed)}:{int(data)}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


class LaneGenerators:
    """One ``torch.Generator`` per lane of a fused run.  A population of
    ``L * n`` rows is laid out lane by lane; a draw of it (``rand``) is
    each lane's own draw of ``n`` rows, in lane order, so lane ``i`` sees
    exactly the stream its unfused run would see."""

    def __init__(self, gens):
        self.gens = list(gens)

    def __len__(self) -> int:
        return len(self.gens)


def rand(gen, shape, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``: a ``torch.Generator``, or a
    ``LaneGenerators`` whose lanes each draw ``shape[0] / L`` leading
    rows."""
    if isinstance(gen, LaneGenerators):
        rows = shape[0] // len(gen)
        return torch.cat([torch.rand((rows, *shape[1:]), generator=g,
                                     device=device) for g in gen.gens])
    return torch.rand(shape, generator=gen, device=device)
