"""Pareto archive: the canonical dominance math + a fixed-capacity
nondominated archive with a persistent on-disk cache (the port of the
search-path half of ``repro.explore.archive``).

    a dominates b  <=>  all(a <= b) and any(a < b)      (all minimized)

* ``dominance_counts`` — every ranking consumer (NSGA environmental
  selection, its telemetry, ``ParetoArchive.insert``) funnels through the
  ``kernels/pareto_rank`` wrapper: the Hopper kernel for a pool on the
  card, whatever its size, and the plain version for a pool on the CPU.
* ``crowding_distance`` / ``hypervolume_2d_jit`` — fixed-shape tensor math
  on the pool's device (stable sorts, as ``jnp.argsort`` is stable).
* ``ParetoArchive`` — fixed-capacity archive over stacked design tensors
  plus an (n, k) objective matrix, kept on the session's device: every
  ``insert`` runs its merge / rank / prune there.  The npz format
  (``__meta``, ``objs``, ``valid``, ``d_<field>``) is the reference's, so
  the port loads archives the reference wrote.
* ``spec_space_key`` — the content hash of a (SystemSpec, DesignSpace)
  pair; the service salts it so the port's fronts never share a cache file
  with the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.pareto_rank.ops import dominance_counts as _kernel_counts
from ..runtime import resolve_device

F = torch.float32
BIG = 1e30         # sentinel objective for invalid / non-finite rows

# shared log-space hypervolume reference: all convergence telemetry measures
# 2-D hypervolume over clipped log-metrics against (HV_LOG_REF,)*2
HV_LOG_REF = 41.0


# ---------------------------------------------------------------------------
# dominance primitives
# ---------------------------------------------------------------------------
def pareto_front(points) -> List[int]:
    """Indices of the Pareto-optimal rows of an (n, k) objective array
    (numpy, all objectives minimized).  Duplicate points are all kept."""
    pts = np.asarray(points, np.float64)
    if pts.ndim == 1:
        pts = pts[:, None]
    n = len(pts)
    if n == 0:
        return []
    le = np.all(pts[:, None, :] <= pts[None, :, :], axis=-1)   # le[i,j]: i<=j
    lt = np.any(pts[:, None, :] < pts[None, :, :], axis=-1)
    dominated = np.any(le & lt, axis=0)                        # any i dom j
    return [int(i) for i in np.flatnonzero(~dominated)]


def dominance_counts(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n,) int32 number of *valid* points dominating each row of ``objs``
    (n, k).  Zero => nondominated.  Routed to the ``pareto_rank`` kernel."""
    return _kernel_counts(objs.to(F).contiguous(),
                          valid.to(torch.bool).contiguous())


def crowding_distance(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NSGA-II crowding distance over the ``valid`` subset of ``objs``
    (n, k).  Boundary points (per-objective min/max among valid rows) get
    +inf; invalid rows get 0."""
    n = objs.shape[0]
    dev = objs.device
    nv = valid.sum()
    c = torch.where(valid[:, None], objs.to(F), torch.inf)  # invalid sort last
    order = torch.argsort(c, dim=0, stable=True)            # (n, k)
    s = c.gather(0, order)
    lo = s[0]
    hi = s.gather(0, (nv - 1).clamp(0, n - 1).expand(1, s.shape[1]))[0]
    rng = (hi - lo).clamp_min(1e-12)
    prev = torch.cat([s[:1], s[:-1]])
    nxt = torch.cat([s[1:], s[-1:]])
    i = torch.arange(n, device=dev)[:, None]
    gap = (nxt - prev) / rng
    gap = torch.where((i == 0) | (i == nv - 1), torch.inf, gap)
    gap = torch.where(i < nv, gap, 0.0)
    cd = torch.zeros_like(gap).scatter_(0, order, gap)
    out = cd[:, 0]
    for j in range(1, cd.shape[1]):
        out = out + cd[:, j]
    return out


def hypervolume_2d(points, ref) -> float:
    """Exact 2-D hypervolume (area dominated w.r.t. ``ref``, both objectives
    minimized; numpy, float64).  Non-finite points and points not
    dominating ``ref`` are ignored."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    ref = np.asarray(ref, np.float64)
    ok = np.all(np.isfinite(pts), axis=1) & np.all(pts < ref[None, :], axis=1)
    pts = pts[ok]
    if len(pts) == 0:
        return 0.0
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    hv, ymin = 0.0, ref[1]
    for x, y in pts:
        if y < ymin:
            hv += (ref[0] - x) * (ymin - y)
            ymin = y
    return float(hv)


def hypervolume_2d_jit(points: torch.Tensor, ref, valid=None) -> torch.Tensor:
    """Fixed-shape exact 2-D hypervolume on the points' device (a 0-d
    float32 tensor).  Filtered points (non-finite, not dominating ``ref``,
    or masked out by ``valid``) move onto the reference point, where they
    contribute zero area.  Used by the NSGA telemetry with no host
    round-trip."""
    pts = points.to(F).reshape(-1, 2)
    ref = torch.as_tensor(ref, dtype=F, device=pts.device).reshape(2)
    ok = torch.isfinite(pts).all(1) & (pts < ref[None, :]).all(1)
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    x = torch.where(ok, pts[:, 0], ref[0])
    y = torch.where(ok, pts[:, 1], ref[1])
    order = torch.argsort(x, stable=True)
    xs, ys = x[order], y[order]
    # running staircase minimum BEFORE each point (ref height to start)
    ymin_prev = torch.cat([ref[1:2], torch.cummin(ys, 0).values[:-1]])
    return ((ref[0] - xs) * (ymin_prev - ys).clamp_min(0.0)).sum()


def objective_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """All C(n, 2) index pairs (i < j) — the 2-D hypervolume projections
    traced for an ``n``-objective exploration.  Empty for n < 2."""
    return tuple((i, j) for i in range(n) for j in range(i + 1, n))


# ---------------------------------------------------------------------------
# convergence telemetry
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ConvergenceTrace:
    """Per-generation convergence telemetry of one search run (host-side
    numpy; the same fields and semantics as the reference's).

    ``hypervolume`` (G, P) is the running 2-D hypervolume of the
    population's feasible front per objective pair over clipped
    log-metrics w.r.t. ``(HV_LOG_REF,)*2``; ``best`` the running best
    penalized scalarized objective; ``archive_hv`` (S, P) one
    archive-projected row per scan segment; ``hv_gen`` (G, P) the
    instantaneous per-generation front hypervolume."""
    objectives: Tuple[str, ...]
    pairs: Tuple[Tuple[str, str], ...]
    front_size: np.ndarray          # (G,) population front size
    hypervolume: np.ndarray         # (G, P) running log-space hv per pair
    best: np.ndarray                # (G,) running best scalarized objective
    feasible_frac: np.ndarray       # (G,) feasible fraction of the children
    n_evals: np.ndarray             # (G,) cumulative evaluations
    archive_hv: Optional[np.ndarray] = None     # (S, P) per scan segment
    hv_gen: Optional[np.ndarray] = None         # (G, P) per generation

    def __post_init__(self):
        self.objectives = tuple(self.objectives)
        self.pairs = tuple(tuple(p) for p in self.pairs)

    @property
    def generations(self) -> int:
        return len(self.front_size)

    @classmethod
    def from_scan(cls, objectives: Sequence[str], scan_trace: Dict,
                  evals_per_generation: int) -> "ConvergenceTrace":
        """Adopt the stacked (G, ...) telemetry a ``make_nsga`` run
        produced (numpy arrays or tensors)."""
        objectives = tuple(objectives)
        tr = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                  else np.asarray(v)) for k, v in scan_trace.items()}
        g = tr["front_size"].shape[0]
        return cls(
            objectives=objectives,
            pairs=tuple((objectives[i], objectives[j])
                        for i, j in objective_pairs(len(objectives))),
            front_size=np.asarray(tr["front_size"], np.int64),
            hypervolume=np.asarray(tr["hypervolume"], np.float64),
            best=np.asarray(tr["best"], np.float64),
            feasible_frac=np.asarray(tr["feasible_frac"], np.float64),
            n_evals=(np.arange(g, dtype=np.int64) + 1)
            * int(evals_per_generation),
            hv_gen=(np.asarray(tr["hv_now"], np.float64)
                    if "hv_now" in tr else None))

    def extend(self, other: "ConvergenceTrace") -> "ConvergenceTrace":
        """Concatenate a follow-on segment: evaluation counts accumulate,
        and the running hv / best stay monotone across the seam."""
        if other.objectives != self.objectives:
            raise ValueError("cannot extend a trace across objective sets")
        off = int(self.n_evals[-1]) if len(self.n_evals) else 0
        cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)])
        hv = np.maximum.accumulate(
            cat(self.hypervolume, other.hypervolume), axis=0)
        ahv = [a for a in (self.archive_hv, other.archive_hv)
               if a is not None]
        hvg = [a for a in (self.hv_gen, other.hv_gen) if a is not None]
        return ConvergenceTrace(
            objectives=self.objectives, pairs=self.pairs,
            front_size=cat(self.front_size, other.front_size),
            hypervolume=hv,
            best=np.minimum.accumulate(cat(self.best, other.best)),
            feasible_frac=cat(self.feasible_frac, other.feasible_frac),
            n_evals=cat(self.n_evals, np.asarray(other.n_evals) + off),
            archive_hv=np.concatenate(ahv, axis=0) if ahv else None,
            hv_gen=np.concatenate(hvg, axis=0) if hvg else None)

    def summary(self) -> Dict:
        """JSON-serializable digest persisted alongside the archive npz."""
        g = self.generations
        return dict(
            generations=int(g),
            n_evals=int(self.n_evals[-1]) if g else 0,
            objectives=list(self.objectives),
            pairs=[list(p) for p in self.pairs],
            front_size_final=int(self.front_size[-1]) if g else 0,
            hypervolume_final=[float(v) for v in self.hypervolume[-1]]
            if g else [],
            best_final=float(self.best[-1]) if g else None,
            feasible_frac_mean=float(np.mean(self.feasible_frac))
            if g else 0.0)


# ---------------------------------------------------------------------------
# crash-safe npz persistence
# ---------------------------------------------------------------------------
def atomic_savez(path, **arrays) -> Path:
    """``np.savez_compressed`` through a same-directory temp file and an
    atomic ``os.replace``: a crash mid-write leaves the previous file (or
    nothing) in place, never a truncated npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f".{path.name}.tmp{os.getpid()}.{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


# ---------------------------------------------------------------------------
# archive update on the device
# ---------------------------------------------------------------------------
def _sanitize(objs):
    return torch.where(torch.isfinite(objs), objs.to(F), BIG)


def _archive_update(objs, valid, designs, new_objs, new_valid, new_designs):
    """Merge a batch into the archive state and prune to capacity: one
    dominance pass over archive + batch, then rank and keep ``cap`` rows."""
    cap = objs.shape[0]
    a_objs = torch.cat([objs, _sanitize(new_objs)], 0)
    a_valid = torch.cat([valid, new_valid], 0) & (a_objs < BIG).all(-1)
    nd = dominance_counts(a_objs, a_valid)
    front = (nd == 0) & a_valid
    crowd = crowding_distance(a_objs, front)
    # ranking (ascending): nondominated by descending crowding (boundary
    # points carry inf crowding => kept first), then dominated/invalid rows
    keyv = torch.where(front, -crowd.clamp(max=1e9),
                       torch.tensor(BIG, dtype=F, device=objs.device)
                       + nd.to(F))
    order = torch.argsort(keyv, stable=True)[:cap]
    return (a_objs[order], front[order],
            {k: torch.cat([designs[k], new_designs[k]], 0)[order]
             for k in designs})


class ParetoArchive:
    """Fixed-capacity nondominated archive over stacked design tensors, on
    one device.

    ``template`` is one design point (a dict of arrays or tensors) fixing
    the leaf shapes; objectives are an (n, ``n_obj``) matrix, all minimized.
    After every ``insert`` the archive holds only mutually nondominated
    points (capacity permitting — overflow is pruned by crowding distance,
    which always keeps per-objective boundary points)."""

    def __init__(self, capacity: int, template: Dict, n_obj: int = 4,
                 obj_keys: Optional[Sequence[str]] = None, device="cuda"):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.n_obj = int(n_obj)
        self.obj_keys = tuple(obj_keys) if obj_keys else None
        self.objs = torch.full((capacity, n_obj), BIG, dtype=F,
                               device=self.device)
        self.valid = torch.zeros(capacity, dtype=torch.bool,
                                 device=self.device)
        self.designs = {
            k: torch.zeros((capacity,) + tuple(np.shape(v)),
                           dtype=torch.int32, device=self.device)
            for k, v in template.items()}
        self.n_evals = 0            # evaluations recorded against this archive
        self.searched = ()          # objective names search was spent on
        self.budget_covered = 0     # largest query budget answered
        self.trace_summary = {}     # last refinement's trace summary

    def __len__(self) -> int:
        return int(self.valid.sum())

    def insert(self, designs: Dict, objs, mask=None, count_evals=True):
        """Insert a stacked batch: ``designs`` leaves (m, ...), ``objs``
        (m, n_obj).  Non-finite objective rows are dropped.  The update
        runs on the archive's device."""
        dev = self.device
        objs = torch.as_tensor(objs, dtype=F, device=dev).reshape(
            -1, self.n_obj)
        m = objs.shape[0]
        new_valid = (torch.ones(m, dtype=torch.bool, device=dev)
                     if mask is None
                     else torch.as_tensor(mask, device=dev).to(torch.bool))
        new_designs = {
            k: torch.as_tensor(v, device=dev).to(torch.int32).reshape(
                (m,) + tuple(self.designs[k].shape[1:]))
            for k, v in designs.items()}
        self.objs, self.valid, self.designs = _archive_update(
            self.objs, self.valid, self.designs, objs, new_valid,
            new_designs)
        if count_evals:
            self.n_evals += int(m)
        return self

    def front(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """(stacked designs of the valid rows, their (n, n_obj) float64
        objectives), as numpy on the host."""
        sel = torch.nonzero(self.valid).flatten()
        return ({k: v[sel].cpu().numpy() for k, v in self.designs.items()},
                self.objs[sel].cpu().numpy().astype(np.float64))

    def projected_hypervolume(self, pair: Tuple[int, int],
                              ref: float = HV_LOG_REF) -> float:
        """2-D hypervolume of the archived front projected onto a pair of
        objective columns, over clipped log-metrics w.r.t. ``(ref, ref)``."""
        i, j = pair
        _, objs = self.front()
        pts = objs[:, [i, j]]
        return hypervolume_2d(np.log(np.maximum(pts, 1e-3)), (ref, ref))

    # ---- persistence -------------------------------------------------------
    def save(self, path) -> Path:
        meta = dict(capacity=self.capacity, n_obj=self.n_obj,
                    n_evals=self.n_evals, searched=list(self.searched),
                    obj_keys=list(self.obj_keys or ()),
                    budget_covered=self.budget_covered,
                    trace_summary=self.trace_summary)
        return atomic_savez(
            path, __meta=np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8),
            objs=self.objs.cpu().numpy(), valid=self.valid.cpu().numpy(),
            **{f"d_{k}": v.cpu().numpy() for k, v in self.designs.items()})

    @classmethod
    def load(cls, path, device="cuda") -> "ParetoArchive":
        """Load an archive npz (the port's or the reference's) onto
        ``device``."""
        with np.load(Path(path)) as z:
            meta = json.loads(bytes(z["__meta"]).decode())
            designs = {k[2:]: z[k] for k in z.files if k.startswith("d_")}
            template = {k: v[0] for k, v in designs.items()}
            arc = cls(meta["capacity"], template, n_obj=meta["n_obj"],
                      obj_keys=meta["obj_keys"] or None, device=device)
            dev = arc.device
            arc.objs = torch.as_tensor(np.array(z["objs"], np.float32),
                                       device=dev)
            arc.valid = torch.as_tensor(np.array(z["valid"], bool),
                                        device=dev)
            arc.designs = {k: torch.as_tensor(np.array(v, np.int32),
                                              device=dev)
                           for k, v in designs.items()}
            arc.n_evals = int(meta["n_evals"])
            arc.searched = tuple(meta.get("searched", ()))
            # archives written before budget accounting: evaluations
            # recorded then were always full-budget spends
            arc.budget_covered = int(meta.get("budget_covered",
                                              meta["n_evals"]))
            arc.trace_summary = dict(meta.get("trace_summary", {}))
        return arc


# ---------------------------------------------------------------------------
# canonical (SystemSpec, DesignSpace) hashing for the on-disk cache
# ---------------------------------------------------------------------------
def spec_space_key(spec, space, extra=None) -> str:
    """Stable content hash of an exploration problem: the padded workload
    arrays plus every static ``DesignSpace`` bound (byte-identical to the
    reference's derivation).  ``extra`` folds further cache identity in —
    the service passes its salt and the tech's ``tech_key`` digest."""
    h = hashlib.sha256()
    if extra is not None:
        h.update(repr(extra).encode())
    h.update(repr((int(spec.W), int(spec.CH), int(spec.E))).encode())
    for k in sorted(spec.arrays):
        a = np.asarray(spec.arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr((tuple(space.max_shape), int(space.max_logB),
                   int(space.max_total_pes), int(space.fixed_packaging),
                   int(space.fixed_family),
                   bool(space.allow_pipeline))).encode())
    return h.hexdigest()[:20]
