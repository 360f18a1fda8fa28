"""Simba [25] and NN-Baton [28] realized inside the Monad framework (paper
Sec. V-B): the port of ``repro.core.baselines``.

Both baselines share Monad's evaluator; what differs is the *frozen* part
of the encoding:

* Simba    — MCM on organic substrate, 2D-mesh package network, a fixed
  36-chiplet-class geometry, and a mapping that spatially divides the
  INPUT and OUTPUT CHANNELS (k, c) at every level.
* NN-Baton — organic substrate, RING network, fewer/larger chiplets, and a
  mapping that spatially divides the OUTPUT PLANE (p, q) across chiplets
  (i, j for matmuls).

The remaining fields (order, tiling, pipeline, placement) are searched by
the same SA engine that Monad uses, so comparisons are iso-optimizer and
iso-PE-budget.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..runtime import resolve_device
from .constants import PKG_ORGANIC
from .encoding import DesignSpace, random_design
from .evaluate import SystemSpec
from .network import FAM_MESH, FAM_RING


@dataclasses.dataclass(frozen=True)
class Baseline:
    name: str
    space: DesignSpace
    init: Dict                       # frozen hardware + mapping strategy
    sa_fields: Tuple[str, ...]       # what its mapper may still tune
    bo_fields: Tuple[str, ...] = ()


def _spatial_for(graph, kind: str) -> np.ndarray:
    """Loop-id pairs per level [PE, core, chiplet] for a mapping strategy.

    kind='channels' (Simba): divide output/input CHANNELS at every level —
    conv (k, c), matmul (j, k).
    kind='plane' (NN-Baton): divide the OUTPUT PLANE across chiplets (conv
    (p, q), matmul (i, j)); inside a chiplet, channel parallelism feeds the
    PE arrays.
    """
    W = len(graph.workloads)
    out = np.zeros((W, 6), np.int32)
    for wi, w in enumerate(graph.workloads):
        names = list(w.loop_names)
        if "k" in names and "c" in names:            # conv
            chan = (names.index("k"), names.index("c"))
            plane = (names.index("p"), names.index("q"))
        elif "i" in names and "j" in names:          # matmul
            chan = (names.index("j"), names.index("k"))
            plane = (names.index("i"), names.index("j"))
        else:                                        # generic contraction
            chan = (1, 2 if len(names) > 2 else 0)
            plane = (0, 1)
        if kind == "channels":
            pe = core = chip = chan
        else:
            pe = core = chan
            chip = plane
        out[wi] = [pe[0], pe[1], core[0], core[1], chip[0], chip[1]]
    return out


def make_baseline(name: str, spec: SystemSpec, key: int,
                  pe_budget: int = 4096, device="cuda") -> Baseline:
    """Instantiate 'simba' / 'nn-baton' / 'monad' under an iso-PE budget;
    ``key`` is an integer seed, ``init`` a design of int32 tensors on
    ``device``."""
    dev = resolve_device(device)
    graph = spec.graph
    W = spec.W
    sa_fields = ("order", "tiling", "pipe", "placement")

    if name == "monad":
        space = DesignSpace(spec, max_total_pes=pe_budget)
        return Baseline(name, space, random_design(key, space, device=dev),
                        sa_fields=sa_fields,
                        bo_fields=("shape", "spatial", "packaging", "family"))

    d = {k: v.cpu().numpy().copy()
         for k, v in random_design(key, DesignSpace(spec), device=dev).items()}
    per_wl = max(pe_budget // max(W, 1), 64)

    if name == "simba":
        # 16 chiplets x 16 cores x 16 PEs class geometry (scaled to budget)
        d["shape"][:] = 0
        d["shape"][:, 0:2] = 4                      # 4x4 PEs / core
        d["shape"][:, 2:4] = 4                      # 4x4 cores
        side = max(int(np.sqrt(per_wl / 256)), 1)
        d["shape"][:, 4] = side
        d["shape"][:, 5] = max(per_wl // (256 * side), 1)
        d["spatial"] = _spatial_for(graph, "channels")
        d["packaging"] = np.int32(PKG_ORGANIC)
        d["family"] = np.int32(FAM_MESH)
    elif name == "nn-baton":
        # fewer, larger chiplets on a ring; output-plane partitioning
        d["shape"][:] = 0
        d["shape"][:, 0:2] = 8                      # 8x8 PEs / core
        d["shape"][:, 2:4] = 2                      # 2x2 cores
        nch = max(per_wl // 256, 1)
        d["shape"][:, 4] = 1
        d["shape"][:, 5] = min(nch, 6)
        d["spatial"] = _spatial_for(graph, "plane")
        d["packaging"] = np.int32(PKG_ORGANIC)
        d["family"] = np.int32(FAM_RING)
    else:
        raise ValueError(name)

    space = DesignSpace(spec, max_total_pes=pe_budget,
                        fixed_packaging=int(d["packaging"]),
                        fixed_family=int(d["family"]))
    init = {k: torch.as_tensor(np.asarray(v, np.int32), device=dev)
            for k, v in d.items()}
    # baselines tune execution order, tiling, pipelining and placement with
    # the same SA engine; geometry/spatial/integration stay frozen.
    return Baseline(name, space, init, sa_fields=sa_fields, bo_fields=())
