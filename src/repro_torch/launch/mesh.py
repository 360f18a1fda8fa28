"""Device meshes: the reference's ``repro/launch/mesh.py``, and the island
mesh of the NSGA engine.

* ``make_production_mesh(multi_pod=False)`` — the (16, 16) ("data",
  "model") mesh of one pod, or (2, 16, 16) ("pod", "data", "model") of
  two, as a ``DeviceMesh`` over the first 256 / 512 ranks of the process
  group that exists (the dry run's fake world: ``fake_world``); given a
  cell's layout ``pc`` that never names "data" without "pod"
  (``names_data_alone``), the two pods' mesh is a ``sharding.FlatMesh``
  over a (32, 16) ``DeviceMesh`` whose first dim holds ("pod", "data")
  flattened: the same ranks and the same layout of every spec that names
  the two axes together, over which DTensor plans its layouts and
  collectives as on one pod's mesh (on three mesh dims its sharding
  propagation and redistribution planning take several times as long);
* ``make_host_mesh(model_parallel=1)`` — a ("data", "model") mesh over
  the world that exists;
* ``fake_world(n)`` — a context that installs torch's fake process group
  of ``n`` ranks in this one process (rank 0; every collective returns at
  once, nothing moves) and tears it down again: enough to lay out DTensors
  and trace a step at 256 or 512 ranks (``launch.dryrun``);
* ``make_island_mesh(islands, devices)`` — an ``IslandMesh``: ``.shape``
  is ``{"islands": n}`` (all ``make_nsga`` and the service read, as the
  reference's ``Mesh``), and its islands are placed on ``devices`` in
  contiguous blocks.

Functions, so that importing this module touches no device or process
group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

import torch

from ..runtime import resolve_device

ISLAND_AXIS = "islands"


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def names_data_alone(pc) -> bool:
    """Whether a layout names the "data" axis without "pod" (the sequence
    of a ``seq_shard`` cell, FSDP over one of the two): such a layout
    needs the three-dim multi-pod mesh."""
    return bool(pc.seq_shard
                or len(set(pc.fsdp_axes) & {"pod", "data"}) == 1)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         pc=None):
    """16 x 16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis,
    flattened with the data axis where the layout ``pc`` allows it (a
    ``ParallelConfig``; none keeps three dims).  ``device`` is the
    ranks' device type (the card unless ``device="cpu"``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel.sharding import FlatMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    dev = resolve_device(device)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — run under "
            f"launch/dryrun.py (it installs a fake world of 512 ranks)")
    if multi_pod and pc is not None and not names_data_alone(pc):
        return FlatMesh(
            DeviceMesh(dev.type, torch.arange(n).reshape(32, 16),
                       mesh_dim_names=("pod_data", "model")),
            ((("pod", 2), ("data", 16)), (("model", 16),)))
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device="cuda"):
    """A ("data", "model") mesh over the ranks of the process group that
    exists (``model_parallel`` capped at the world size)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    world = _world()
    if world < 1:
        raise RuntimeError("make_host_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    mp = max(1, min(int(model_parallel), world))
    dp = world // mp
    return DeviceMesh(dev.type, torch.arange(dp * mp).reshape(dp, mp),
                      mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(n: int):
    """Torch's fake process group of ``n`` ranks, this process rank 0, for
    the context's duration.  Raises if a process group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class IslandMesh:
    """``islands`` NSGA islands on ``devices`` (contiguous blocks)."""
    islands: int
    devices: Tuple[torch.device, ...]

    @property
    def shape(self):
        return {ISLAND_AXIS: self.islands}

    def blocks(self) -> List[Tuple[torch.device, List[int]]]:
        """[(device, its islands)] in island order: island i on device
        ``i * D // n`` of the D devices (the first n where D > n)."""
        n = self.islands
        nb = min(len(self.devices), n)
        return [(self.devices[b], [i for i in range(n) if i * nb // n == b])
                for b in range(nb)]


def make_island_mesh(islands: int, devices=("cuda",)) -> IslandMesh:
    """An island mesh of ``islands`` over ``devices`` (each resolved by
    ``runtime.resolve_device``: the card unless ``"cpu"``).  The same
    device may be named twice: its islands then run as two blocks, as on
    two cards (the CPU tests' split)."""
    if int(islands) < 1:
        raise ValueError("make_island_mesh: islands must be >= 1")
    if not devices:
        raise ValueError("make_island_mesh: give at least one device")
    return IslandMesh(int(islands), tuple(resolve_device(d)
                                          for d in devices))
