"""Logical sharding rules: the per-dimension mesh axes of every parameter,
batch and cache tensor — the reference's ``repro/parallel/sharding.py``.

The rules are data, as in the reference: ``param_spec``, ``batch_spec``
and ``cache_spec`` return a ``P`` (a ``PartitionSpec``-like tuple, one
entry a dimension: ``None``, an axis name, or a tuple of axis names), and
``placements(spec, mesh)`` turns one into DTensor placements on a
``DeviceMesh``: a dimension over ("pod", "data") is ``Shard(d)`` on both
mesh dims, in mesh order; a mesh dim no dimension names is
``Replicate()``.

Layout philosophy (the reference's): every large weight is 2-D sharded —
the contraction-safe dim over ``model`` (TP), the other over the
("pod", "data") FSDP axes — and a dim is sharded only where the axis
extent divides it.  MoE experts shard over ``model`` when the expert
count divides it, else each expert is TP-sharded internally.

The port keeps one module a layer (``blocks.3.attn.wq.w``) where the
reference stacks the layers on a leading axis (``blocks/attn/wq/w`` with
shape (L, ...)): ``param_spec`` reads the name with the layer index
dropped and returns the reference's spec without its leading ``None``.

A mesh is anything with named extents: a ``DeviceMesh`` with
``mesh_dim_names``, a ``FlatMesh`` (a ``DeviceMesh`` one of whose dims
holds several axes flattened, as the multi-pod mesh's ("pod", "data")),
or a stand-in whose ``.shape`` is a dict of axis -> extent
(``launch.mesh.IslandMesh``, the tests' stand-ins).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..models.config import ModelConfig, ParallelConfig

# batch parallelism axes (always on; fsdp_axes controls weight sharding)
DATA_AXES = ("pod", "data")


class P(tuple):
    """A ``PartitionSpec``: one entry a tensor dimension (a one-axis tuple
    is kept as its axis name, as ``PartitionSpec`` keeps it)."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class FlatMesh:
    """``device_mesh`` (a ``DeviceMesh``) read as named axes: ``axes`` holds,
    for each of its dims in order, the (axis, extent) pairs flattened into
    it, outer first.  A dimension laid over all the axes of a flattened dim
    is one ``Shard`` of it: the same ranks hold the same blocks as ``Shard``
    on each axis of an unflattened mesh, and DTensor plans its layouts over
    fewer mesh dims.  A spec that names only some axes of a flattened dim
    cannot be laid out on it (``placements`` raises)."""
    device_mesh: object
    axes: Tuple[Tuple[Tuple[str, int], ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {a: n for dim in self.axes for a, n in dim}

    def size(self) -> int:
        return self.device_mesh.size()


def device_mesh_of(mesh):
    """The ``DeviceMesh`` of a ``DeviceMesh`` or a ``FlatMesh``; None for a
    stand-in."""
    if isinstance(mesh, FlatMesh):
        return mesh.device_mesh
    return mesh if hasattr(mesh, "mesh_dim_names") else None


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: extent} of a ``DeviceMesh`` or a stand-in."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("sharding: the mesh must name its dimensions")
    return dict(zip(names, tuple(shape)))


def _axis_size(shape: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return n


def _div(dim: int, shape: Dict[str, int], axes) -> bool:
    return dim % max(_axis_size(shape, axes), 1) == 0


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Resolved mesh axes for this run (missing axes are dropped)."""
    fsdp: Tuple[str, ...]
    tensor: str

    def fs(self, mesh):
        shape = mesh_shape(mesh)
        return tuple(a for a in self.fsdp if a in shape) or None

    def tp(self, mesh):
        return self.tensor if self.tensor in mesh_shape(mesh) else None


def make_rules(pc: ParallelConfig) -> AxisRules:
    return AxisRules(fsdp=tuple(pc.fsdp_axes), tensor=pc.tensor_axis)


def param_spec(name: str, shape, cfg: ModelConfig, mesh,
               rules: AxisRules) -> P:
    """The spec of the parameter ``name`` (the port's dotted name, as
    ``named_parameters()`` gives it) of ``shape``: the reference's spec of
    the same leaf, without the leading ``None`` of a stacked layer."""
    names = [n for n in name.split(".") if not n.isdigit()]
    leaf, parent = names[-1], (names[-2] if len(names) >= 2 else "")
    ms = mesh_shape(mesh)
    fs, tp = rules.fs(mesh), rules.tp(mesh)
    shp = tuple(shape)

    def guard(spec_dims):
        return P(*(ax if ax is not None and _div(d, ms, ax) else None
                   for d, ax in zip(shp, spec_dims)))

    replicated = P(*([None] * len(shp)))
    if leaf == "embed":
        return guard((tp, fs))
    if leaf in ("scale", "b", "conv_b", "D", "meta"):
        if leaf == "b" and parent in ("wq", "wk", "wv", "wg", "wu"):
            return guard((tp,))
        return replicated
    if parent in ("wq", "wk", "wv", "wg", "wu"):
        return guard((fs, tp))
    if parent in ("wo", "wd", "out_proj"):
        return guard((tp, fs))
    if parent == "lm_head":
        return guard((fs, tp))
    if parent == "router":
        return guard((fs, None))
    if leaf in ("wg", "wu") and len(shp) == 3:                 # MoE (E, d, f)
        if _div(shp[0], ms, tp):
            return guard((tp, fs, None))                       # EP
        return guard((None, fs, tp))                           # expert-TP
    if leaf == "wd" and len(shp) == 3:                         # MoE (E, f, d)
        if _div(shp[0], ms, tp):
            return guard((tp, None, fs))
        return guard((None, tp, fs))
    if parent == "in_proj":                                    # mamba (d, 2di)
        return guard((fs, tp))
    if leaf == "conv_w":
        return guard((None, tp))
    if parent == "x_proj":
        return guard((tp, None))
    if parent == "dt_proj":
        return guard((None, tp))
    if leaf == "A_log":
        return guard((tp, None))
    if parent == "wkv_down":                                   # MLA down-proj
        return guard((fs, None))
    if parent in ("wk_up", "wv_up"):
        return guard((None, tp))
    return replicated


def param_specs(module, cfg: ModelConfig, mesh,
                rules: AxisRules) -> Dict[str, P]:
    """{name: spec} over ``module.named_parameters()``."""
    return {n: param_spec(n, p.shape, cfg, mesh, rules)
            for n, p in module.named_parameters()}


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one a mesh dim): a mesh
    axis that a dimension names is ``Shard`` of that dimension, any other
    ``Replicate`` — as is an axis of extent 1, over which a shard is the
    whole tensor."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(mesh, FlatMesh):
        dims = [tuple(a for a, _ in dim) for dim in mesh.axes]
    else:
        dims = [(axis,) for axis in mesh_shape(mesh)]
    extents = mesh_shape(mesh)
    out = []
    for names in dims:
        dim = None
        for d, ax in enumerate(spec):
            named = {ax} if isinstance(ax, str) else set(ax or ())
            if named & set(names):
                if not named >= set(names):
                    raise ValueError(
                        f"sharding: spec {spec!r} names {sorted(named)}, "
                        f"part of the flattened mesh dim {names}")
                dim = d
        out.append(Replicate() if dim is None
                   or _axis_size(extents, names) == 1 else Shard(dim))
    return tuple(out)


def param_shardings(module, cfg: ModelConfig, mesh, rules: AxisRules):
    """{name: placements} of every parameter of ``module`` on ``mesh``."""
    return {n: placements(s, mesh)
            for n, s in param_specs(module, cfg, mesh, rules).items()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def _batch_axes(shape: Dict[str, int]):
    return tuple(a for a in DATA_AXES if a in shape) or None


def batch_spec(cfg: ModelConfig, pc: ParallelConfig, mesh, batch: int,
               seq: int) -> Dict[str, P]:
    ms = mesh_shape(mesh)
    fs = _batch_axes(ms)
    bax = fs if batch % max(_axis_size(ms, fs), 1) == 0 else None
    sax = "data" if (pc.seq_shard and bax is None
                     and seq % max(_axis_size(ms, "data"), 1) == 0) else None
    specs = {"tokens": P(bax, sax), "labels": P(bax, sax),
             "loss_mask": P(bax, sax)}
    if cfg.family == "encdec":
        specs["audio_embeds"] = P(bax, None, None)
    if cfg.family == "vlm":
        specs["patch_embeds"] = P(bax, None, None)
        specs["positions"] = P(bax, sax, None)
    return specs


def cache_spec(cfg: ModelConfig, pc: ParallelConfig, mesh, batch: int):
    """Specs of the KV / SSM cache tree (decode cells), leading layer axis
    included (the port's caches keep it).

    decode_kv='sequence': the cache's sequence dim over the model axis
    (flash-decoding's partial softmax), the layout the advisor picks where
    the KV heads do not divide the model axis; 'heads': head-sharded."""
    ms = mesh_shape(mesh)
    tp = make_rules(pc).tp(mesh)
    fs = _batch_axes(ms)
    bax = fs if batch % max(_axis_size(ms, fs), 1) == 0 else None
    mode = pc.decode_kv
    if mode == "auto":
        kv_ok = cfg.n_kv_heads > 0 and _div(cfg.n_kv_heads, ms, tp)
        mode = "heads" if kv_ok else "sequence"

    def kv():
        if mode == "heads":
            return P(None, bax, None, tp, None)
        return P(None, bax, tp, None, None)

    if cfg.family == "ssm":
        return (P(None, bax, None, tp), P(None, bax, tp, None))
    if cfg.family == "hybrid":
        attn = (kv(), kv(), P(None, bax, None))
        ssm = (P(None, bax, None, tp), P(None, bax, tp, None))
        return (attn, ssm)
    if cfg.use_mla:
        return P(None, bax, tp, None)
    if cfg.family == "encdec":
        return {"self": (kv(), kv()), "enc": P(bax, None, None)}
    return (kv(), kv())


def lay_out(tree, specs, mesh):
    """``tree`` (tensors in tuples and dicts) as DTensors laid out by the
    matching tree of specs (``distribute``)."""
    if isinstance(specs, P):
        return distribute(tree, mesh, placements(specs, mesh))
    if isinstance(specs, dict):
        return {k: lay_out(tree[k], specs[k], mesh) for k in tree}
    return type(tree)(lay_out(t, sp, mesh) for t, sp in zip(tree, specs))


def like_tree(specs, mesh):
    """The placements of every spec of a tree (tuples, lists, dicts)."""
    if isinstance(specs, P):
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: like_tree(v, mesh) for k, v in specs.items()}
    return type(specs)(like_tree(v, mesh) for v in specs)



def distribute_module(module, cfg: ModelConfig, mesh, rules: AxisRules):
    """Replace every parameter of ``module`` (in place) by a DTensor on
    ``mesh`` laid out by ``param_spec`` (``distribute``), and install the
    kernels' sharding rules.  Returns the module."""
    from torch import nn

    from ..kernels.sharding import register
    register()
    for name, p in list(module.named_parameters()):
        pl = placements(param_spec(name, p.shape, cfg, mesh, rules), mesh)
        owner, _, attr = name.rpartition(".")
        m = module.get_submodule(owner) if owner else module
        setattr(m, attr, nn.Parameter(distribute(p.detach(), mesh, pl),
                                      requires_grad=p.requires_grad))
    return module


def distribute(t, mesh, pl):
    """``t`` as a DTensor of ``pl`` on ``mesh``: a real tensor scattered
    from its full value (every rank holding the same), a fake or meta one
    (a spec) its rank's local shard of the same kind."""
    import torch
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = device_mesh_of(mesh)
    if is_fake(t) or t.is_meta:
        local_shape, _ = compute_local_shape_and_global_offset(
            t.shape, mesh, pl)
        local = torch.empty(local_shape, dtype=t.dtype, device=t.device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl)
