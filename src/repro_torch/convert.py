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
  ``tech_to_dict``;
* ``load_reference_params`` / ``lm_params_from_reference`` — a reference
  LM parameter pytree of any family (nested dicts of arrays; ``blocks``,
  or ``encoder`` and ``decoder``, stacked on a leading layer axis; expert
  tensors (E, d, f), MLA's keys, the shared experts) as the port's
  parameter modules;
* ``train_state_from_reference`` — a reference training state
  (``{"params", "opt": {"mu", "nu", "step"}}``) as the port's
  (``launch.train.make_train_state``'s layout), the moments in their own
  dtype;
* ``surrogate_from_reference`` — a reference ``Surrogate`` or
  ``NonlinearTrustModel`` as the port's (the ensemble weights and
  normalization statistics as numpy), so both packages compute the same
  function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.constants import TechConstants, tech_from_dict, tech_to_dict
from .core.evaluate import SystemSpec
from .core.workload import Edge, TensorRef, Workload, WorkloadGraph
from .explore.surrogate import (NonlinearTrustModel, Surrogate,
                                SurrogateConfig)
from .models.config import ModelConfig
from .models.model import lm_module
from .runtime import resolve_device


def design_to_torch(design: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """A design pytree (numpy / JAX arrays) as int32 tensors on ``device``
    (the card unless ``device="cpu"``; see ``runtime.resolve_device``)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.int32), device=dev)
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


def _flatten(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _layer(tree, i: int):
    """Layer ``i`` of a pytree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_reference_params(module: torch.nn.Module,
                          tree: Dict) -> torch.nn.Module:
    """Copy a reference parameter pytree into ``module``'s parameters of
    the same dotted names (``{"wq": {"w": ...}}`` -> ``wq.w``), in place,
    onto the module's device.  Every parameter must be matched exactly,
    in name and shape."""
    sd = {k: torch.as_tensor(np.array(v)) for k, v in _flatten(tree)}
    module.load_state_dict(sd, strict=True)
    return module


def lm_params_from_reference(params: Dict, cfg: ModelConfig,
                             device="cuda") -> torch.nn.Module:
    """The port's parameters (``models.model.DecoderLM``, or ``EncDecLM``
    for ``encdec``, on ``device``: the card unless ``device="cpu"``)
    holding a reference LM's weights: ``params`` is the reference
    ``Model.init`` pytree, whose layer stacks (``blocks``, or ``encoder``
    and ``decoder``) carry a leading layer axis (the reference vmaps its
    block init)."""
    dev = resolve_device(device)
    tree = dict(params)
    for name, n in (("blocks", cfg.n_layers), ("encoder", cfg.enc_layers),
                    ("decoder", cfg.n_layers)):
        if name in tree:
            stacked = tree.pop(name)
            tree[name] = {str(i): _layer(stacked, i) for i in range(n)}
    return load_reference_params(lm_module(cfg, dev), tree)


def train_state_from_reference(state: Dict, cfg: ModelConfig,
                               device="cuda") -> Dict:
    """The port's training state (on ``device``: the card unless
    ``device="cpu"``) holding a reference state: the parameters as
    ``lm_params_from_reference`` makes them, taking gradients; each moment
    tree through the same mapping into a dict keyed by the parameters'
    names, in the moments' dtype (bfloat16 goes through float32, exactly);
    the step count as an int32 0-dim tensor."""
    dev = resolve_device(device)
    params = lm_params_from_reference(state["params"], cfg, dev)
    params.requires_grad_(True)
    opt = {"step": torch.tensor(int(np.asarray(state["opt"]["step"])),
                                dtype=torch.int32, device=dev)}
    for key in ("mu", "nu"):
        tree = state["opt"][key]
        dtype = str(np.asarray(next(_flatten(tree))[1]).dtype)
        as_f32 = _map_tree(lambda a: np.asarray(a, np.float32), tree)
        moments = lm_params_from_reference(as_f32, cfg, dev)
        opt[key] = {n: p.detach().to(getattr(torch, dtype))
                    for n, p in moments.named_parameters()}
    return {"params": params, "opt": opt}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def surrogate_from_reference(model):
    """A reference ``Surrogate`` (or ``NonlinearTrustModel``) as the
    port's: the same ensemble weights (leading member axis) and
    normalization statistics, as numpy."""
    params = {k: np.array(v, np.float32) for k, v in model.params.items()}
    if hasattr(model, "config"):
        return Surrogate(
            params=params, x_mean=np.array(model.x_mean, np.float32),
            x_std=np.array(model.x_std, np.float32),
            y_mean=np.array(model.y_mean, np.float32),
            y_std=np.array(model.y_std, np.float32),
            config=SurrogateConfig(**dataclasses.asdict(model.config)),
            n_rows=int(model.n_rows))
    return NonlinearTrustModel(
        params=params, x_mean=np.array(model.x_mean, np.float32),
        x_std=np.array(model.x_std, np.float32), y_mean=float(model.y_mean),
        y_std=float(model.y_std), dim=int(model.dim))
