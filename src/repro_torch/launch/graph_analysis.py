"""Count the work of one step on fake tensors, and price it on a roofline:
the counterpart of the reference's ``repro/launch/hlo_analysis.py``.  There
is no HLO in the port, so the count is taken from the operators eager
PyTorch dispatches, not parsed out of a compiled module.

``analyze(fn, *specs, device="cuda")`` turns the specs (``launch.specs``:
tensors on meta, parameter modules, nested dicts, tuples and lists of
them) into fake tensors on ``device`` (``FakeTensorMode``: shapes, dtypes
and devices, no storage) and runs ``fn`` on them once under ``StepCounter``,
a ``TorchDispatchMode``.  Nothing is launched, and nothing is allocated but
the few 0-dim tensors a step makes from Python numbers (``torch.tensor(0)``,
``torch.as_tensor(0.0)``), which fake tensor mode keeps real so that their
values are known: a kernel of the port is an operator of its own
(``kernels.define``) whose fake implementation gives only the outputs'
shapes.  The counter reads:

* **FLOPs**: every operator of ``torch.utils.flop_counter``'s registry by
  its formula (2 M N K for the matmul family: ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; convolutions and SDPA, which the port does not call), and
  every kernel operator by its own formula (``kernels/<name>/cost.py``,
  the one the card's bounds in ``chip_smoke.py`` read);
* **bytes**, twice: ``bytes_all``, each operator's input and output
  tensors (views move nothing), what eager PyTorch moves through HBM; and
  ``bytes_heavy``, the reference's selection (``_HEAVY_KINDS``): matmuls,
  gathers, scatters, slice updates, collectives and the kernel operators,
  for parity with its roofline;
* **collective wire bytes** from the ``_c10d_functional`` operators at the
  ring factors of the reference's ``collective_stats``, the group size
  read from the operator (its argument, or its process group); an
  ``all_to_all_single`` that sends to one rank alone is a
  ``collective-permute`` (a pipeline hop: wire = the bytes sent); the
  wire is also summed by the group's ranks (``group_wire``), so that the
  roofline prices a group that spans nodes of its target on the network,
  and by the line of the port that issued it (``wire_sites``: the
  innermost frame of ``repro_torch`` outside the layout helpers, e.g.
  ``models/layers.py:314 mla_apply``);
* **memory**: the peak of the live fake storages' bytes over the step,
  inputs included (a storage dies when its last tensor does);
* **kernels**: each kernel operator's calls, the launches they make on the
  card, and their FLOPs and bytes.

DTensors: an operator on DTensors is left to DTensor (the counter returns
``NotImplemented`` for it), which runs it on the local shards and issues
the collectives its layouts need; the counter then counts those, so a
sharded step reads per-device FLOPs, bytes and wire.  A DTensor input's
live bytes are its local shard's.

Loops: eager tracing unrolls every loop of the step (the layer stack, the
microbatches, the decode loop a caller writes), so one trace counts each
trip as it runs.  ``extrapolate`` is the counterpart of the reference's
``ModuleAnalysis`` trip counts (XLA counts a ``while`` body once and
multiplies it by its trip count): a caller traces the step at two small
counts of each loop (``launch.dryrun.trip_plan``: one and two remat
groups of layers, two and three microbatches) and every summed count is
evaluated at the full counts from the corners, as a multilinear function
of them; the peak of live bytes by the same rule.  An 80-layer step of 8
microbatches then costs four traces of 4 or 8 layers and 2 or 3
microbatches: qwen2-72b ``train_4k`` in its default layout traced in
372.5 s unrolled and 46.9 s by trip counts, every summed count and the
peak equal (fake CUDA tensors on the host of an NVIDIA H100 80GB HBM3 at
700.00 W; ``PERF.md``).

``Roofline`` and ``roofline(...)`` are the reference's three-term model,
priced on ``core.constants.DEFAULT_H100``.

A fake CUDA tensor needs no card: a forward traces on fake CUDA tensors
on any build of PyTorch.  Autograd on them needs a build with CUDA (its
engine asks the CUDA runtime for the device's stream), so without one a
training step traces with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import os
import sys
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core.constants import DEFAULT_H100, H100Target
from ..kernels.flash_attention import cost as fa_cost
from ..kernels.flash_attention import ops as fa_ops
from ..kernels.gp_cov import cost as gp_cost
from ..kernels.gp_cov import ops as gp_ops
from ..kernels.mamba_scan import cost as ms_cost
from ..kernels.mamba_scan import ops as ms_ops
from ..kernels.pareto_rank import cost as pareto_cost
from ..kernels.pareto_rank import ops as pareto_ops

aten = torch.ops.aten

# kernel operator -> the work of one call (flops, bytes, launches)
KERNEL_COSTS = {
    pareto_ops.OP: pareto_cost.op_work,
    gp_ops.OP: gp_cost.op_work,
    fa_ops.FWD: fa_cost.fwd_op_work,
    fa_ops.FWD_LSE: fa_cost.fwd_lse_op_work,
    fa_ops.BWD: fa_cost.bwd_op_work,
    ms_ops.FWD: ms_cost.fwd_op_work,
    ms_ops.FWD_STATES: ms_cost.fwd_states_op_work,
    ms_ops.BWD: ms_cost.bwd_op_work,
}

# the reference's heavy kinds as aten operators: gathers and dynamic
# slices (priced at twice their output), slice updates (twice the update),
# scatters (inputs and outputs); matmuls, collectives and kernels apart
_GATHERS = {aten.gather, aten.index, aten.index_select, aten.embedding,
            aten.take_along_dim}
_UPDATES = {aten.copy_, aten.slice_scatter, aten.select_scatter}
_SCATTERS = {aten.scatter, aten.scatter_, aten.scatter_add,
             aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
             aten.index_add, aten.index_add_, aten.index_put,
             aten.index_put_, aten._index_put_impl_, aten.index_copy,
             aten.index_copy_}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
# with the pipeline's hop: the kinds a step's wire is counted under
WIRE_KINDS = COLLECTIVES + ("collective-permute",)


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Wire bytes a device sends for one collective over ``n`` ranks whose
    per-device result is ``size`` bytes (the reference's ring factors):
    all-reduce 2 size (n-1)/n, all-gather size (n-1)/n, reduce-scatter
    size n (n-1)/n (its input is n results), all-to-all size (n-1)/n; a
    collective-permute sends its ``size`` once (one hop)."""
    n = max(int(n), 1)
    f = (n - 1) / n
    return {"all-reduce": 2.0 * size * f, "all-gather": size * f,
            "reduce-scatter": size * n * f, "all-to-all": size * f,
            "collective-permute": float(size)}[kind]


def _group(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


def _group_ranks(group_name: str) -> Tuple[int, ...]:
    import torch.distributed as dist
    return tuple(dist.get_process_group_ranks(_group(group_name)))


def inter_node_wire(group_wire: Dict[Tuple[int, ...], float],
                    node_gpus: int) -> float:
    """The wire of the groups whose ranks lie in more than one node of
    ``node_gpus`` consecutive ranks."""
    n = max(int(node_gpus), 1)
    return float(sum(w for ranks, w in group_wire.items()
                     if len({r // n for r in ranks}) > 1))


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NOT_SITES = tuple(os.path.join(_PACKAGE, f) for f in (
    os.path.join("launch", "graph_analysis.py"),
    os.path.join("parallel", "ctx.py"), os.path.join("parallel",
                                                     "sharding.py")))


def _site() -> str:
    """The line of the port that issued the operator running now: the
    innermost frame of the package outside this module and the layout
    helpers (``parallel/ctx.py``, ``parallel/sharding.py``)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PACKAGE) and not name.startswith(_NOT_SITES):
            return (f"{os.path.relpath(name, _PACKAGE)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


def _collective(func, args) -> Optional[tuple]:
    """(kind, group size, group name, bytes it sends or None for its
    output's) of a ``_c10d_functional`` collective, else None."""
    if func.namespace != "_c10d_functional":
        return None
    name = func._overloadpacket.__name__
    if name in ("all_reduce", "all_reduce_"):
        return "all-reduce", _group(args[2]).size(), args[2], None
    if name == "all_gather_into_tensor":
        return "all-gather", int(args[1]), args[2], None
    if name == "reduce_scatter_tensor":
        return "reduce-scatter", int(args[2]), args[3], None
    if name == "all_to_all_single":
        sends = [int(x) for x in (args[2] or [])]
        if sum(1 for x in sends if x) <= 1 and args[2] is not None:
            # one destination: a permute hop, its wire what it sends
            return ("collective-permute", _group(args[3]).size(), args[3],
                    _nbytes(args[0]))
        return "all-to-all", _group(args[3]).size(), args[3], None
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _spec_tensors(tree) -> list:
    """Every tensor of a tree of specs: modules' parameters and buffers at
    any depth included."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, nn.Module):
            out += [*x.parameters(), *x.buffers()]
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


class StepCounter(TorchDispatchMode):
    """Counts what every operator dispatched under it does (see the module
    docstring); ``track(tensors)`` puts the step's inputs in the live
    bytes."""

    def __init__(self):
        super().__init__()
        self.group_wire: Dict[Tuple[int, ...], float] = {}
        self.wire_sites: Dict[str, float] = {}
        self.paused = 0
        self.flops = 0.0
        self.flops_kernels = 0.0
        self.bytes_all = 0.0
        self.bytes_heavy = 0.0
        self.wire = dict.fromkeys(WIRE_KINDS, 0.0)
        self.collectives = dict.fromkeys(WIRE_KINDS, 0)
        self.kernels: Dict[str, Dict] = {}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._alive = set()

    # ---- live storages ---------------------------------------------------
    def _free(self, key: int, nbytes: int):
        self._alive.discard(key)
        self.live -= nbytes

    def track(self, tensors):
        for t in tensors:
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._alive:
                continue
            nbytes = st.nbytes()
            self._alive.add(key)
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        self.peak = max(self.peak, self.live)

    # ---- one operator ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:                  # DTensor's layout bookkeeping
            return out
        outs = _tensors(out)
        self.track(outs)
        if func.is_view or not outs:
            return out
        self.ops += 1
        cost = KERNEL_COSTS.get(func)
        if cost is not None:
            w = cost(*args, **kwargs)
            k = self.kernels.setdefault(func.name(), dict(
                calls=0, launches=0, flops=0.0, bytes=0.0))
            k["calls"] += 1
            k["launches"] += w["launches"]
            k["flops"] += w["flops"]
            k["bytes"] += w["bytes"]
            self.flops += w["flops"]
            self.flops_kernels += w["flops"]
            self.bytes_all += w["bytes"]
            self.bytes_heavy += w["bytes"]
            return out
        ins = _tensors((args, kwargs))
        io = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes_all += io
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
            self.bytes_heavy += io
        elif packet in _GATHERS:
            self.bytes_heavy += 2.0 * sum(map(_nbytes, outs))
        elif packet in _UPDATES:
            self.bytes_heavy += 2.0 * _nbytes(ins[-1])
        elif packet in _SCATTERS:
            self.bytes_heavy += io
        else:
            col = _collective(func, args)
            if col is not None:
                kind, n, group, sent = col
                w = wire_bytes(kind, _nbytes(outs[0]) if sent is None
                               else sent, n)
                self.wire[kind] += w
                ranks = _group_ranks(group)
                self.group_wire[ranks] = self.group_wire.get(ranks, 0.0) + w
                site = _site()
                self.wire_sites[site] = self.wire_sites.get(site, 0.0) + w
                self.collectives[kind] += 1
                self.bytes_heavy += io
        return out


@dataclasses.dataclass
class StepAnalysis:
    flops: float                  # matmul family + kernel operators
    flops_kernels: float          # the kernel operators' share
    bytes_all: float              # every operator's inputs + outputs
    bytes_heavy: float            # the reference's heavy selection
    wire_bytes: Dict[str, float]  # per collective kind, per device
    collectives: Dict[str, int]
    total_wire_bytes: float
    group_wire: Dict[Tuple[int, ...], float]   # by the group's ranks
    wire_sites: Dict[str, float]  # by the line of the port that issued it
    peak_bytes: int               # live fake storages, inputs included
    input_bytes: int
    kernels: Dict[str, Dict]      # operator -> calls, launches, flops, bytes
    ops: int                      # operators counted (views apart)
    result: object = None         # what ``fn`` returned (fake tensors)


def _to_fake(spec, device: torch.device, memo: dict):
    """``spec`` with every tensor a fake tensor on ``device`` (same shape,
    dtype and requires_grad; a 0-dim integer spec, a host-visible counter
    such as the optimizer's step, becomes a fake 0 whose value the step
    may read), modules copied with fake parameters."""
    if isinstance(spec, torch.Tensor):
        key = id(spec)
        if key not in memo and isinstance(spec, DTensor):
            local = _to_fake(spec._local_tensor, device, {})
            fake = DTensor.from_local(local, spec.device_mesh,
                                      spec.placements, run_check=False,
                                      shape=spec.shape, stride=spec.stride())
            if isinstance(spec, nn.Parameter):
                fake = nn.Parameter(fake, requires_grad=spec.requires_grad)
            memo[key] = fake
        if key not in memo:
            if spec.dim() == 0 and not spec.is_floating_point():
                fake = torch.tensor(0, dtype=spec.dtype, device=device)
            else:
                fake = torch.empty(spec.shape, dtype=spec.dtype,
                                   device=device)
            if isinstance(spec, nn.Parameter):
                fake = nn.Parameter(fake, requires_grad=spec.requires_grad)
            elif spec.requires_grad:
                fake.requires_grad_(True)
            memo[key] = fake
        return memo[key]
    if isinstance(spec, nn.Module):
        # the copy takes the fakes in place of the parameters and buffers
        fakes = {id(t): _to_fake(t, device, memo) for t in (
            *spec.parameters(), *spec.buffers())}
        return copy.deepcopy(spec, memo=fakes)
    if isinstance(spec, dict):
        return {k: _to_fake(v, device, memo) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(_to_fake(v, device, memo) for v in spec)
    return spec


@contextlib.contextmanager
def _patched(cls, name: str, wrap):
    """``cls.name`` replaced by ``wrap(original)`` for the context (left
    alone where this PyTorch has no such attribute)."""
    orig = getattr(cls, name, None) if cls is not None else None
    if orig is None:
        yield
        return
    setattr(cls, name, functools.wraps(orig)(wrap(orig)))
    try:
        yield
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def _dtensor_internals(counter: "StepCounter"):
    """What DTensor computes about layouts is not the step's work: its
    sharding propagation builds fake tensors of the GLOBAL shapes to read
    an operator's output metadata, which ``counter`` must neither count
    nor hold live (it pauses for them); and a strided shard's offsets
    come from an ``arange`` read back with ``tolist``, which fake tensor
    mode cannot answer (it runs with the modes off, on a few real
    indices)."""
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    def paused(orig):
        def run(*args, **kwargs):
            counter.paused += 1
            try:
                return orig(*args, **kwargs)
            finally:
                counter.paused -= 1
        return run

    def off_modes(orig):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return orig(*args, **kwargs)
        return run
    with contextlib.ExitStack() as stack:
        for name in ("propagate_op_sharding_non_cached",
                     "_propagate_tensor_meta_non_cached"):
            stack.enter_context(_patched(ShardingPropagator, name, paused))
        stack.enter_context(_patched(getattr(pt, "_StridedShard", None),
                                     "local_shard_size_and_offset",
                                     off_modes))
        yield


def analyze(fn, *specs, device="cuda") -> StepAnalysis:
    """Run ``fn(*specs)`` once on fake tensors on ``device`` (see the module
    docstring) and return what ``StepCounter`` counted.  A DTensor spec
    (parameters laid out on a mesh over meta shards) becomes a DTensor of
    the same layout over fake shards."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"analyze: unsupported device {device!r}; use "
                         f"'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.backends.cuda.is_built() \
            and any(t.requires_grad for t in _spec_tensors(specs)):
        raise RuntimeError(
            "analyze: autograd on fake CUDA tensors needs a build of PyTorch "
            "with CUDA; pass device='cpu' to trace the step on this one")
    counter = StepCounter()
    with FakeTensorMode(allow_non_fake_inputs=False):
        fakes = _to_fake(list(specs), dev, {})
        counter.track(_spec_tensors(fakes))
        input_bytes = counter.live
        with counter, _dtensor_internals(counter):
            result = fn(*fakes)
    return StepAnalysis(
        flops=counter.flops, flops_kernels=counter.flops_kernels,
        bytes_all=counter.bytes_all, bytes_heavy=counter.bytes_heavy,
        wire_bytes=dict(counter.wire), collectives=dict(counter.collectives),
        total_wire_bytes=float(sum(counter.wire.values())),
        group_wire=dict(counter.group_wire),
        wire_sites=dict(counter.wire_sites), peak_bytes=counter.peak,
        input_bytes=input_bytes, kernels=counter.kernels, ops=counter.ops,
        result=result)


# ---------------------------------------------------------------------------
# trip counts
# ---------------------------------------------------------------------------
def _leaves(an: StepAnalysis) -> Dict[tuple, float]:
    """The counts of ``an`` as {key: value}."""
    out = {("flops",): an.flops, ("flops_kernels",): an.flops_kernels,
           ("bytes_all",): an.bytes_all, ("bytes_heavy",): an.bytes_heavy,
           ("input_bytes",): an.input_bytes, ("ops",): an.ops,
           ("peak_bytes",): an.peak_bytes}
    out.update({("wire_bytes", k): v for k, v in an.wire_bytes.items()})
    out.update({("collectives", k): v for k, v in an.collectives.items()})
    out.update({("group_wire", r): v for r, v in an.group_wire.items()})
    out.update({("wire_sites", r): v for r, v in an.wire_sites.items()})
    out.update({("kernels", n, f): v for n, rec in an.kernels.items()
                for f, v in rec.items()})
    return out


def extrapolate(traces: Dict[Tuple[int, ...], StepAnalysis],
                lo: Tuple[int, ...], hi: Tuple[int, ...],
                target: Tuple[int, ...]) -> StepAnalysis:
    """The analysis of a step at the trip counts ``target`` from traces of
    it at fewer trips: the counterpart of the reference's ``ModuleAnalysis``,
    which counts a ``while`` body once and multiplies it by its trip count.

    Each trip count i (a stack's layers, the microbatches) was traced at
    ``lo[i]`` and, where ``hi[i] != lo[i]``, at ``hi[i]`` too: ``traces``
    maps each corner (every count at its ``lo`` or its ``hi``) to its
    analysis.  Every summed count (FLOPs, bytes, wire by kind, by
    group and by site, collectives, kernel calls, launches, FLOPs and bytes, operators,
    the inputs' bytes) is a multilinear function of the trip counts when
    each trip past the first does the same work: the corners fix it, and
    it is evaluated at ``target`` (a body times its trips, and the product
    of the two loops, as nested scans scale).  The peak of live bytes is a
    maximum, not a sum; it is extrapolated by the same rule, which holds
    where the same point of the step holds the peak at every corner and
    each trip adds the same live bytes there (a layer's parameters,
    optimizer state and saved group boundary; past the second microbatch,
    whose gradients accumulate onto the first's, what a microbatch keeps
    until the loop ends).  A count that is not a whole number at
    ``target`` is refused."""
    n = len(lo)
    free = [i for i in range(n) if hi[i] != lo[i]]
    scale = [(target[i] - lo[i]) / (hi[i] - lo[i]) for i in free]
    leaves = {}
    for mask in range(1 << len(free)):
        # the corner with the counts of ``mask`` raised, weighted by its
        # share of every mixed difference that holds it
        w = 1.0
        for j, k in enumerate(scale):
            w *= k if mask >> j & 1 else 1.0 - k
        corner = tuple(hi[i] if i in free and mask >> free.index(i) & 1
                       else lo[i] for i in range(n))
        for key, v in _leaves(traces[corner]).items():
            leaves[key] = leaves.get(key, 0.0) + w * v

    def get(*key):
        return leaves.get(key, 0.0)

    def whole(x):
        # a count (calls, launches, collectives, operators, bytes) is an
        # integer combination of the corners' counts
        n = round(x)
        if abs(x - n) > 1e-6:
            raise ValueError(f"extrapolate: a count came out {x!r}, not "
                             f"a whole number")
        return int(n)
    kinds = sorted({k[1] for k in leaves if k[0] == "wire_bytes"},
                   key=WIRE_KINDS.index)
    wire = {k: get("wire_bytes", k) for k in kinds}
    kernels = {}
    for k in leaves:
        if k[0] == "kernels":
            rec = kernels.setdefault(k[1], {})
            v = leaves[k]
            rec[k[2]] = whole(v) if k[2] in ("calls", "launches") else v
    return StepAnalysis(
        flops=get("flops"), flops_kernels=get("flops_kernels"),
        bytes_all=get("bytes_all"), bytes_heavy=get("bytes_heavy"),
        wire_bytes=wire,
        collectives={k: whole(get("collectives", k)) for k in kinds},
        total_wire_bytes=float(sum(wire.values())),
        group_wire={k[1]: v for k, v in leaves.items()
                    if k[0] == "group_wire"},
        wire_sites={k[1]: v for k, v in leaves.items()
                    if k[0] == "wire_sites"},
        peak_bytes=whole(get("peak_bytes")),
        input_bytes=whole(get("input_bytes")),
        kernels=kernels, ops=whole(get("ops")))


# ---------------------------------------------------------------------------
# the three-term roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float
    hlo_total_flops: float
    useful_ratio: float
    bottleneck: str
    step_time_s: float
    roofline_frac: float

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline(flops_per_device: float, bytes_per_device: float,
             wire_bytes_per_device: float, n_chips: int,
             model_flops: float, model_min_bytes: float = 0.0,
             target: H100Target = DEFAULT_H100,
             group_wire: Optional[Dict[Tuple[int, ...], float]] = None
             ) -> Roofline:
    """Three-term roofline, all per card: compute_s = FLOPs / peak;
    memory_s = bytes / HBM rate; collective_s = wire bytes / (links x link
    rate), the share of them over groups that span more than one node of
    ``target.node_gpus`` cards (``group_wire``: wire by the group's ranks,
    as ``analyze`` records it) at ``target.net_gbps`` instead.  ``roofline_frac`` = ideal time / the largest term, the ideal
    time being the better of the two hardware floors: useful model FLOPs at
    peak, or the compulsory bytes (weights and caches that must stream once
    a step, dominant for decode) at the full HBM rate.  ``hlo_total_flops``
    keeps the reference's name: the counted FLOPs of all cards."""
    compute_s = flops_per_device / (target.peak_bf16_tflops * 1e12)
    memory_s = bytes_per_device / (target.hbm_gbps * 1e9)
    net = inter_node_wire(group_wire or {}, target.node_gpus)
    collective_s = (wire_bytes_per_device - net) / (
        target.links_per_chip * target.link_gbps * 1e9)
    if net:
        collective_s += net / (target.net_gbps * 1e9)
    hlo_total = flops_per_device * n_chips
    useful = model_flops / max(hlo_total, 1.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(compute_s, memory_s, collective_s)
    ideal = max((model_flops / n_chips) / (target.peak_bf16_tflops * 1e12),
                (model_min_bytes / n_chips) / (target.hbm_gbps * 1e9))
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_device=flops_per_device, bytes_per_device=bytes_per_device,
        wire_bytes_per_device=wire_bytes_per_device,
        model_flops=model_flops, hlo_total_flops=hlo_total,
        useful_ratio=useful, bottleneck=bottleneck, step_time_s=step,
        roofline_frac=ideal / max(step, 1e-30))
