"""Uniform encoding of the architecture + integration design space
(paper Sec. IV-B, Fig. 6a) — the search half of ``repro.core.encoding``.

Architecture fields (per workload):
    shape   (W, 6)   geometry of PE / core / chiplet arrays (raw dims)
    spatial (W, 6)   spatially-parallelized loop per array dim per level
    order   (W, 3, L) loop permutation per level (execution order)
    tiling  (W, 2, L) tile sizes (core tile t1, chiplet tile t2)
    pipe    (W,)     pipelined loop id (== L means "not pipelined")
    logB    ()       log2 of pipeline tick count

Integration fields:
    packaging ()       0 organic / 1 passive / 2 active interposer
    family    ()       network topology family (chain/ring/mesh/star)
    placement (W*CH,)  global chiplet id -> network node id (a permutation)

The portable design IR (``SpaceDigest``, ``to_portable`` / ``from_portable``,
``migrate``, ``portable_signature``, ``repair``) is host-side numpy, as in
the reference: it takes the port's tensors or numpy and returns numpy.

Every sampling and move function here works on populations: each field carries a leading
dimension P.  Per-row permutations are the ``argsort`` of uniform draws;
``mutate`` computes every move of ``fields`` for every design and keeps one
per design by mask, where the reference dispatches with ``lax.switch``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime import LaneGenerators, generator, rand, resolve_device
from .evaluate import SystemSpec
from .network import MAX_NODES, N_FAMILIES
from .workload import MAX_LOOPS, graph_feature_rows, workload_signature

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Static bounds of the explorable space for one SystemSpec."""
    spec: SystemSpec
    max_shape: Tuple[int, ...] = (16, 16, 4, 4, 6, 6)   # per-level max dims
    max_logB: int = 6
    max_total_pes: int = 0          # 0 = unconstrained (Fig-7 fairness knob)
    fixed_packaging: int = -1       # >=0 pins the field (ablation studies)
    fixed_family: int = -1
    allow_pipeline: bool = True

    @property
    def W(self):
        return self.spec.W

    @property
    def CH(self):
        return self.spec.CH

    @property
    def n_loops(self) -> np.ndarray:
        return self.spec.arrays["loopmask"].sum(axis=1).astype(np.int32)

    @property
    def bounds(self) -> np.ndarray:
        return self.spec.arrays["bounds"]

    def max_nodes(self) -> int:
        return min(MAX_NODES, self.W * self.CH)


def _randint(gen, shape, low, high, device):
    """Uniform integers in [low, high); ``high`` may be a tensor that
    broadcasts against ``shape`` (per-element upper bounds)."""
    u = rand(gen, shape, device)
    v = low + torch.floor(u * (high - low)).to(torch.int64)
    top = high - 1
    return (torch.minimum(v, top) if torch.is_tensor(top)
            else v.clamp_max(top)).to(I32)


@lru_cache(maxsize=64)
def _const(values: tuple, device: torch.device, dtype=None) -> torch.Tensor:
    """A small constant table on ``device``, copied there once: a copy from
    host memory synchronizes the stream, so the SA and NSGA step loops
    must not make one per step.  Callers only read it."""
    return torch.as_tensor(values, dtype=dtype, device=device)


def _rand_perm_rows(gen, shape, device):
    """Independent uniform permutations of the last axis of ``shape``."""
    return torch.argsort(rand(gen, shape, device),
                         dim=-1).to(I32)


def random_design(key, space: DesignSpace, n: Optional[int] = None,
                  nl=None, bounds=None, device="cuda") -> Dict:
    """Uniform random design points (the paper's 'Random' baseline): a
    population of ``n`` designs (fields with a leading dim n), or one
    design without the leading dim when ``n`` is None.

    ``key`` is an integer seed or a ``torch.Generator`` on ``device``, or
    a ``runtime.LaneGenerators`` (``n`` rows lane by lane, each lane's
    rows drawn from its own generator); ``nl``/``bounds`` may be passed as
    tensors (the workload's loop counts (W,) and bounds (W, L), as in the
    reference), or per row ((n, W) and (n, W, L)), so the rows of a fused
    run each sample their own problem."""
    dev = resolve_device(device)
    gen = (key if isinstance(key, (torch.Generator, LaneGenerators))
           else generator(key, dev))
    m = 1 if n is None else int(n)
    W, CH, L = space.W, space.CH, MAX_LOOPS
    mx = torch.as_tensor(space.max_shape, device=dev)
    shape = _randint(gen, (m, W, 6), 1, mx + 1, dev)
    nl = torch.as_tensor(space.n_loops if nl is None else nl,
                         device=dev).long()
    nl1 = nl.clamp_min(1)
    spatial = _randint(gen, (m, W, 6), 0, nl1[..., None], dev)
    order = _rand_perm_rows(gen, (m, W, 3, L), dev)
    bounds = torch.as_tensor(space.bounds if bounds is None else bounds,
                             device=dev)
    tmax = bounds.clamp_min(1).to(torch.float32)
    u = rand(gen, (m, W, 2, L), dev)
    tiling = (tmax[..., None, :] ** u).clamp_min(1.0).to(I32)
    on = rand(gen, (m, W), dev) < 0.5
    pipe_loop = _randint(gen, (m, W), 0, nl1, dev)
    pipe = torch.where(on & space.allow_pipeline, pipe_loop,
                       torch.full_like(pipe_loop, L))
    logB = (_randint(gen, (m,), 0, space.max_logB + 1, dev)
            if space.allow_pipeline else torch.zeros(m, dtype=I32, device=dev))
    packaging = (torch.full((m,), space.fixed_packaging, dtype=I32, device=dev)
                 if space.fixed_packaging >= 0
                 else _randint(gen, (m,), 0, 3, dev))
    family = (torch.full((m,), space.fixed_family, dtype=I32, device=dev)
              if space.fixed_family >= 0
              else _randint(gen, (m,), 0, N_FAMILIES, dev))
    placement = _rand_perm_rows(gen, (m, W * CH), dev)
    d = dict(shape=shape, spatial=spatial, order=order, tiling=tiling,
             pipe=pipe, logB=logB, packaging=packaging, family=family,
             placement=placement)
    return d if n is not None else {k: v[0] for k, v in d.items()}


def balanced_init(key, space: DesignSpace, total_pes: int = 4096,
                  device="cuda") -> Dict:
    """Paper Sec. IV-B: assign PEs to each workload proportionally to its
    MAC count so pipeline stages are roughly balanced.  One design (no
    leading dim) on ``device``: a ``random_design`` drawn from ``key`` (an
    integer seed or a ``torch.Generator``) with its shape field replaced by
    the deterministic per-workload PE split."""
    d = random_design(key, space, device=device)
    macs = np.array([w.macs for w in space.spec.graph.workloads], np.float64)
    share = macs / macs.sum()
    pes = np.maximum((share * total_pes).astype(np.int64), 64)
    side = np.clip(np.sqrt(pes / 4).astype(np.int32), 1,
                   np.asarray(space.max_shape)[:2].min())
    shape = d["shape"].cpu().numpy().copy()
    shape[:, 0] = side
    shape[:, 1] = side
    shape[:, 2:4] = 2
    shape[:, 4:6] = 1
    d["shape"] = torch.as_tensor(shape, device=d["shape"].device)
    return d


# ---------------------------------------------------------------------------
# SA neighborhood moves (one random field mutation per design per call)
# ---------------------------------------------------------------------------
ARCH_FIELDS = ("shape", "spatial", "order", "tiling", "pipe")
INTEG_FIELDS = ("packaging", "family", "placement")
ALL_FIELDS = ARCH_FIELDS + INTEG_FIELDS
# high-dimensional fields owned by the SA engine (paper Sec. IV-C)
SA_FIELDS = ("order", "tiling", "pipe", "placement")
# low-dimensional fields owned by the Bayesian engine
BO_FIELDS = ("shape", "spatial", "packaging", "family")


def mutate(gen: torch.Generator, design: Dict, space: DesignSpace,
           fields: Tuple[str, ...] = ALL_FIELDS,
           nl=None, bounds=None) -> Dict:
    """One random neighbor move per design, restricted to ``fields``.

    ``design`` is a population (fields with a leading dim P) on the
    generator's device.  Each design draws its workload and its move; every
    move of ``fields`` is computed for the whole population and each design
    keeps the one it drew.  ``gen`` may be a ``runtime.LaneGenerators``,
    and ``nl`` / ``bounds`` per row ((P, W) and (P, W, L)), as
    ``random_design`` takes them."""
    dev = design["shape"].device
    P = design["shape"].shape[0]
    W, CH, L = space.W, space.CH, MAX_LOOPS
    nl = torch.as_tensor(space.n_loops if nl is None else nl,
                         device=dev).long().clamp_min(1)
    bounds_arr = torch.as_tensor(space.bounds if bounds is None else bounds,
                                 device=dev).long()
    ar = torch.arange(P, device=dev)
    wsel = _randint(gen, (P,), 0, W, dev).long()
    mid = _randint(gen, (P,), 0, len(fields), dev)
    nl_w = nl[ar, wsel] if nl.dim() == 2 else nl[wsel]

    def pick(values):
        idx = _randint(gen, (P,), 0, len(values), dev).long()
        return _const(tuple(values), dev)[idx]

    # --- architecture moves -------------------------------------------------
    def mv_shape():
        i = _randint(gen, (P,), 0, 6, dev).long()
        delta = pick([-2, -1, 1, 2]).to(I32)
        s = design["shape"].clone()
        s[ar, wsel, i] += delta
        mx = _const(tuple(space.max_shape), dev, I32)
        return dict(shape=torch.minimum(s.clamp_min(1), mx))

    def mv_spatial():
        i = _randint(gen, (P,), 0, 6, dev).long()
        v = _randint(gen, (P,), 0, nl_w, dev)
        s = design["spatial"].clone()
        s[ar, wsel, i] = v
        return dict(spatial=s)

    def mv_order():
        lvl = _randint(gen, (P,), 0, 3, dev).long()
        i = _randint(gen, (P,), 0, L, dev).long()
        j = _randint(gen, (P,), 0, L, dev).long()
        o = design["order"].clone()
        a, b = o[ar, wsel, lvl, i], o[ar, wsel, lvl, j]
        o[ar, wsel, lvl, i] = b
        o[ar, wsel, lvl, j] = a
        return dict(order=o)

    def mv_tiling():
        lvl = _randint(gen, (P,), 0, 2, dev).long()
        i = _randint(gen, (P,), 0, nl_w, dev).long()
        f = pick([0.25, 0.5, 2.0, 4.0])
        bmax = (bounds_arr[ar, wsel, i] if bounds_arr.dim() == 3
                else bounds_arr[wsel, i]).to(I32)
        t = design["tiling"][ar, wsel, lvl, i].to(torch.float32) * f
        t = torch.minimum(t.to(I32).clamp_min(1), bmax)
        tl = design["tiling"].clone()
        tl[ar, wsel, lvl, i] = t.clamp_min(1)
        return dict(tiling=tl)

    def mv_pipe():
        on = rand(gen, (P,), dev) < (
            0.7 if space.allow_pipeline else 0.0)
        loop = _randint(gen, (P,), 0, nl_w, dev)
        step = _randint(gen, (P,), -1, 2, dev)
        pp = design["pipe"].clone()
        pp[ar, wsel] = torch.where(on, loop, L).to(I32)
        logB = torch.where(
            on, (design["logB"] + step).clamp(0, space.max_logB),
            design["logB"]).to(I32)
        return dict(pipe=pp, logB=logB)

    # --- integration moves ---------------------------------------------------
    def mv_packaging():
        if space.fixed_packaging >= 0:
            return {}
        return dict(packaging=_randint(gen, (P,), 0, 3, dev))

    def mv_family():
        if space.fixed_family >= 0:
            return {}
        return dict(family=_randint(gen, (P,), 0, N_FAMILIES, dev))

    def mv_placement():
        i = _randint(gen, (P,), 0, W * CH, dev).long()
        j = _randint(gen, (P,), 0, W * CH, dev).long()
        p = design["placement"].clone()
        a, b = p[ar, i], p[ar, j]
        p[ar, i] = b
        p[ar, j] = a
        return dict(placement=p)

    all_moves = dict(shape=mv_shape, spatial=mv_spatial, order=mv_order,
                     tiling=mv_tiling, pipe=mv_pipe, packaging=mv_packaging,
                     family=mv_family, placement=mv_placement)
    out = dict(design)
    for mi, f in enumerate(fields):
        sel = mid == mi
        for k, v in all_moves[f]().items():
            out[k] = torch.where(sel.view((P,) + (1,) * (v.dim() - 1)), v,
                                 out[k])
    return out


def feasibility_penalty(space: DesignSpace, design: Dict, metrics=None):
    """Soft constraints: total chiplets <= placeable nodes; optional PE
    budget (Fig. 7 iso-PE comparisons).  A (P,) multiplicative penalty."""
    s = design["shape"].long()
    n_chips = (s[..., 4] * s[..., 5]).sum(-1)
    over_nodes = (n_chips - space.max_nodes()).clamp_min(0).to(torch.float32)
    pes = s.prod(-1).sum(-1)
    if space.max_total_pes > 0:
        over_pes = (pes - space.max_total_pes).clamp_min(0).to(torch.float32)
    else:
        over_pes = torch.zeros_like(over_nodes)
    return 1.0 + over_nodes + over_pes / 64.0


# ---------------------------------------------------------------------------
# portable (spec-independent) design IR — the cross-workload transfer
# substrate.  A raw design is a dict of arrays padded to ONE SystemSpec's
# (W, CH, E); a PortableDesign re-keys those arrays by *workload identity*
# (``workload_signature``) so knowledge moves between spec spaces:
#
#     design_A --to_portable--> PortableDesign --from_portable--> design_B
#
# ``migrate`` composes the two; ``repair`` makes any design dict feasible
# under a destination DesignSpace (permutation fields re-ranked, bounds
# clipped, chiplet-count / PE-budget constraints enforced), so migrated
# seeds are always legal population members.  Host-side numpy throughout;
# the results equal the reference's on the same inputs.
# ---------------------------------------------------------------------------
_PLACE_FAR = 1e15          # placement rank key for unmatched chiplet slots


def _np(v) -> np.ndarray:
    """A design leaf as numpy (tensors come back from their device)."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


@dataclasses.dataclass(frozen=True)
class SpaceDigest:
    """The facts about an exploration problem that migration needs — a
    pure-data view of (SystemSpec.graph, DesignSpace) that is JSON-portable,
    so the archive manifest can persist it and a later process can migrate
    out of a cached archive without reconstructing the source graph."""
    W: int
    CH: int
    signatures: Tuple[str, ...]        # per-workload identity hashes
    features: np.ndarray               # (W, WL_FEATURE_DIM) matching rows
    bounds: np.ndarray                 # (W, MAX_LOOPS) padded loop bounds
    n_loops: np.ndarray                # (W,)
    max_shape: Tuple[int, ...]
    max_logB: int
    max_total_pes: int
    fixed_packaging: int
    fixed_family: int
    allow_pipeline: bool

    def max_nodes(self) -> int:
        return min(MAX_NODES, self.W * self.CH)

    def to_json_dict(self) -> Dict:
        return dict(
            W=int(self.W), CH=int(self.CH),
            signatures=list(self.signatures),
            features=np.asarray(self.features, np.float64).tolist(),
            bounds=np.asarray(self.bounds, np.int64).tolist(),
            n_loops=np.asarray(self.n_loops, np.int64).tolist(),
            max_shape=[int(v) for v in self.max_shape],
            max_logB=int(self.max_logB),
            max_total_pes=int(self.max_total_pes),
            fixed_packaging=int(self.fixed_packaging),
            fixed_family=int(self.fixed_family),
            allow_pipeline=bool(self.allow_pipeline))

    @classmethod
    def from_dict(cls, d: Dict) -> "SpaceDigest":
        return cls(
            W=int(d["W"]), CH=int(d["CH"]),
            signatures=tuple(d["signatures"]),
            features=np.asarray(d["features"], np.float64),
            bounds=np.asarray(d["bounds"], np.int64),
            n_loops=np.asarray(d["n_loops"], np.int64),
            max_shape=tuple(int(v) for v in d["max_shape"]),
            max_logB=int(d["max_logB"]),
            max_total_pes=int(d["max_total_pes"]),
            fixed_packaging=int(d["fixed_packaging"]),
            fixed_family=int(d["fixed_family"]),
            allow_pipeline=bool(d["allow_pipeline"]))


def space_digest(space: DesignSpace) -> SpaceDigest:
    graph = space.spec.graph
    return SpaceDigest(
        W=space.W, CH=space.CH,
        signatures=tuple(workload_signature(w) for w in graph.workloads),
        features=graph_feature_rows(graph),
        bounds=np.asarray(space.bounds, np.int64),
        n_loops=np.asarray(space.n_loops, np.int64),
        max_shape=tuple(space.max_shape), max_logB=space.max_logB,
        max_total_pes=space.max_total_pes,
        fixed_packaging=space.fixed_packaging,
        fixed_family=space.fixed_family,
        allow_pipeline=space.allow_pipeline)


SpaceLike = Union[DesignSpace, SpaceDigest, Dict]


def _as_digest(x: SpaceLike) -> SpaceDigest:
    if isinstance(x, SpaceDigest):
        return x
    if isinstance(x, DesignSpace):
        return space_digest(x)
    if isinstance(x, dict):
        return SpaceDigest.from_dict(x)
    raise TypeError(f"cannot digest {type(x).__name__}")


@dataclasses.dataclass
class PortableDesign:
    """One design point in spec-independent form: per-workload records
    (each carrying the workload's identity signature + feature row and its
    architecture fields) plus the global integration fields.  ``place_key``
    is the workload's chiplet slots' positions in the source placement
    permutation, so placements survive re-ranking into any destination
    permutation length."""
    records: List[Dict]
    logB: int
    packaging: int
    family: int


def to_portable(design: Dict, src: SpaceLike) -> PortableDesign:
    dg = _as_digest(src)
    d = {k: _np(v) for k, v in design.items()}
    records = []
    for wi in range(dg.W):
        g0 = wi * dg.CH
        records.append(dict(
            signature=dg.signatures[wi],
            features=np.asarray(dg.features[wi], np.float64),
            shape=d["shape"][wi].copy(),
            spatial=d["spatial"][wi].copy(),
            order=d["order"][wi].copy(),
            tiling=d["tiling"][wi].copy(),
            pipe=np.int32(d["pipe"][wi]),
            place_key=d["placement"][g0:g0 + dg.CH].astype(np.float64)))
    return PortableDesign(records=records, logB=int(d["logB"]),
                          packaging=int(d["packaging"]),
                          family=int(d["family"]))


def _match_records(records: Sequence[Dict], dg: SpaceDigest) -> List[int]:
    """One source record per destination workload: first-unused exact
    signature match, then any exact match, then nearest feature row
    (unused records preferred on ties).  Deterministic."""
    sigs = [r["signature"] for r in records]
    feats = np.stack([np.asarray(r["features"], np.float64)
                      for r in records])
    used: set = set()
    out: List[int] = []
    for wi in range(dg.W):
        cand = [k for k, s in enumerate(sigs) if s == dg.signatures[wi]]
        j = next((k for k in cand if k not in used),
                 cand[0] if cand else None)
        if j is None:
            f = np.asarray(dg.features[wi], np.float64)
            if feats.shape[1] == f.shape[0]:
                dist = np.linalg.norm(feats - f[None, :], axis=1)
            else:           # feature layout drifted: any record will do
                dist = np.arange(len(records), dtype=np.float64)
            dist = dist + 1e-9 * np.asarray(
                [k in used for k in range(len(records))], np.float64)
            j = int(np.argmin(dist))
        used.add(j)
        out.append(j)
    return out


def from_portable(pd: PortableDesign, dst: SpaceLike) -> Dict:
    """Materialize a PortableDesign into a destination space's raw design
    dict (numpy).  Always ends in ``repair``, so the result is feasible
    whatever the source/destination mismatch."""
    dg = _as_digest(dst)
    if not pd.records:
        raise ValueError("cannot materialize an empty PortableDesign")
    W, CH, L = dg.W, dg.CH, MAX_LOOPS
    match = _match_records(pd.records, dg)
    shape = np.ones((W, 6), np.int32)
    spatial = np.zeros((W, 6), np.int32)
    order = np.zeros((W, 3, L), np.int32)
    tiling = np.ones((W, 2, L), np.int32)
    pipe = np.full((W,), L, np.int32)
    keys = np.empty((W * CH,), np.float64)
    for wi, j in enumerate(match):
        r = pd.records[j]
        shape[wi] = r["shape"]
        spatial[wi] = r["spatial"]
        order[wi] = r["order"]
        tiling[wi] = r["tiling"]
        pipe[wi] = r["pipe"]
        pk = np.asarray(r["place_key"], np.float64)
        for c in range(CH):
            g = wi * CH + c
            keys[g] = pk[c] if c < len(pk) else _PLACE_FAR + g
    design = dict(
        shape=shape, spatial=spatial, order=order, tiling=tiling, pipe=pipe,
        logB=np.asarray(pd.logB, np.int32),
        packaging=np.asarray(pd.packaging, np.int32),
        family=np.asarray(pd.family, np.int32),
        placement=keys)           # repair re-ranks into a permutation
    return repair(design, dg)


def migrate(design: Dict, src: SpaceLike, dst: SpaceLike) -> Dict:
    """Move one design between spec spaces: re-key its per-workload fields
    by workload identity, re-rank its placement, repair into feasibility.
    Migrating a repaired design through a superset space (same workloads,
    >= CH, >= bounds) and back is the identity."""
    return from_portable(to_portable(design, src), dst)


def portable_signature(design: Dict, space: SpaceLike) -> str:
    """Content hash of one design in its portable form.  Two repaired
    designs in the same space hash equal iff their portable forms are
    identical: transfer seeding drops migrated seeds whose signature the
    destination archive's front already holds."""
    pd = to_portable(design, space)
    h = hashlib.sha256()
    h.update(repr((int(pd.logB), int(pd.packaging),
                   int(pd.family))).encode())
    for r in pd.records:
        h.update(r["signature"].encode())
        for k in ("shape", "spatial", "order", "tiling", "pipe"):
            h.update(np.asarray(r[k], np.int64).tobytes())
        h.update(np.asarray(r["place_key"], np.float64).tobytes())
    return h.hexdigest()[:16]


def _rank(values: np.ndarray) -> np.ndarray:
    """Stable rank — any real-valued key vector becomes a permutation of
    ``range(n)`` preserving relative order; a permutation maps to itself."""
    return np.argsort(np.argsort(values, kind="stable"), kind="stable")


def repair(design: Dict, space: SpaceLike) -> Dict:
    """Project a design dict onto the feasible set of a destination space
    (numpy out): every field clipped into its legal range,
    ``order``/``placement`` re-ranked into valid permutations, and the hard
    constraints (chiplet count <= placeable nodes, optional total-PE
    budget) enforced by halving the widest offending dims.  Idempotent."""
    dg = _as_digest(space)
    W, CH, L = dg.W, dg.CH, MAX_LOOPS
    d = {k: np.array(_np(v)) for k, v in design.items()}
    mx = np.asarray(dg.max_shape, np.int64)
    nl = np.maximum(np.asarray(dg.n_loops, np.int64), 1)
    bounds = np.maximum(np.asarray(dg.bounds, np.int64), 1)

    d["shape"] = np.clip(d["shape"].reshape(W, 6), 1,
                         mx[None, :]).astype(np.int32)
    d["spatial"] = np.clip(d["spatial"].reshape(W, 6), 0,
                           (nl - 1)[:, None]).astype(np.int32)
    o = d["order"].reshape(W * 3, L)
    d["order"] = np.stack([_rank(row) for row in o]).astype(
        np.int32).reshape(W, 3, L)
    d["tiling"] = np.clip(d["tiling"].reshape(W, 2, L), 1,
                          bounds[:, None, :]).astype(np.int32)
    pipe = d["pipe"].reshape(W).astype(np.int64)
    pipe = np.where((pipe < 0) | (pipe >= nl), L, pipe)
    if not dg.allow_pipeline:
        pipe = np.full((W,), L, np.int64)
    d["pipe"] = pipe.astype(np.int32)
    logB = int(np.clip(np.asarray(d["logB"]).reshape(()), 0, dg.max_logB))
    d["logB"] = np.asarray(logB if dg.allow_pipeline else 0, np.int32)
    pkg = int(np.clip(np.asarray(d["packaging"]).reshape(()), 0, 2))
    d["packaging"] = np.asarray(
        dg.fixed_packaging if dg.fixed_packaging >= 0 else pkg, np.int32)
    fam = int(np.clip(np.asarray(d["family"]).reshape(()), 0,
                      N_FAMILIES - 1))
    d["family"] = np.asarray(
        dg.fixed_family if dg.fixed_family >= 0 else fam, np.int32)
    d["placement"] = _rank(
        np.asarray(d["placement"], np.float64).reshape(W * CH)).astype(
            np.int32)

    # hard constraint 1: total chiplets <= placeable network nodes
    sh = d["shape"].astype(np.int64)
    while int((sh[:, 4] * sh[:, 5]).sum()) > dg.max_nodes():
        w = int(np.argmax(sh[:, 4] * sh[:, 5]))
        j = 4 + int(np.argmax(sh[w, 4:6]))
        if sh[w, j] <= 1:
            break
        sh[w, j] //= 2
    # hard constraint 2: optional total-PE budget
    if dg.max_total_pes > 0:
        while int(np.prod(sh, axis=1).sum()) > dg.max_total_pes:
            w = int(np.argmax(np.prod(sh, axis=1)))
            j = int(np.argmax(sh[w]))
            if sh[w, j] <= 1:
                break
            sh[w, j] //= 2
    d["shape"] = sh.astype(np.int32)
    return d
