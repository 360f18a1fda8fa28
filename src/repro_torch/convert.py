"""Carry the JAX reference's state into the port, and back, through numpy.

The port imports nothing of ``repro``; these helpers are duck-typed over
the reference's objects (dataclasses with the same field names, numpy or
JAX arrays that ``np.asarray`` accepts):

* ``design_to_torch`` / ``design_to_numpy`` — design pytrees (one design or
  a stacked population) to int32 tensors on a device, and back;
* ``graph_from_reference`` / ``spec_from_reference`` — a reference
  ``WorkloadGraph`` or ``SystemSpec`` as the port's own objects (spec
  arrays copied with the reference dtypes; ``core.evaluate.spec_tensors``
  puts them on a device);
* ``tech_from_reference`` — a reference ``TechConstants`` through
  ``tech_to_dict``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.constants import TechConstants, tech_from_dict, tech_to_dict
from .core.evaluate import SystemSpec
from .core.workload import Edge, TensorRef, Workload, WorkloadGraph


def design_to_torch(design: Dict, device="cpu") -> Dict[str, torch.Tensor]:
    """A design pytree (numpy / JAX arrays) as int32 tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v, np.int32), device=device)
            for k, v in design.items()}


def design_to_numpy(design: Dict) -> Dict[str, np.ndarray]:
    """A design dict of tensors as int32 numpy arrays."""
    return {k: v.detach().cpu().numpy().astype(np.int32)
            for k, v in design.items()}


def graph_from_reference(graph) -> WorkloadGraph:
    """A reference ``WorkloadGraph`` rebuilt from the port's classes."""
    wls = [Workload(name=w.name, loops=tuple(tuple(l) for l in w.loops),
                    tensors=tuple(TensorRef(t.name, tuple(
                        tuple(g) for g in t.dims), t.is_output)
                        for t in w.tensors),
                    flops_per_instance=w.flops_per_instance)
           for w in graph.workloads]
    edges = [Edge(e.src, e.dst, e.tensor_src, e.tensor_dst)
             for e in graph.edges]
    return WorkloadGraph(wls, edges)


def spec_from_reference(spec) -> SystemSpec:
    """A reference ``SystemSpec`` as the port's (arrays copied)."""
    return SystemSpec(W=int(spec.W), CH=int(spec.CH), E=int(spec.E),
                      arrays={k: np.array(v) for k, v in spec.arrays.items()},
                      graph=graph_from_reference(spec.graph))


def tech_from_reference(tech) -> TechConstants:
    """A reference ``TechConstants`` as the port's, field by field."""
    return tech_from_dict(tech_to_dict(tech))
