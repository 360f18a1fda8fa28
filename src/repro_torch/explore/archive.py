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
  ``merge`` folds a peer process's copy of the same archive in (the
  reload-under-lock half of the shared-cache write path).
* ``spec_space_key`` — the content hash of a (SystemSpec, DesignSpace)
  pair; the service salts it so the port's fronts never share a cache file
  with the reference's.
* ``ArchiveManifest`` — the nearest-neighbor index over every archived
  problem of a cache directory (workload embeddings, migration digests,
  LRU / dedup growth policy, the transfer trust table), host-side numpy in
  the reference's file format.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
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


def dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True iff point ``a`` dominates ``b`` (all minimized): a 0-dim bool
    tensor on their device."""
    return torch.all(a <= b) & torch.any(a < b)


def dominance_counts(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n,) int32 number of *valid* points dominating each row of ``objs``
    (n, k).  Zero => nondominated.  Routed to the ``pareto_rank`` kernel;
    a leading lane axis ((L, n, k) and (L, n) -> (L, n)) ranks every lane
    on its own in the same one launch."""
    return _kernel_counts(objs.to(F).contiguous(),
                          valid.to(torch.bool).contiguous())


def crowding_distance(objs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NSGA-II crowding distance over the ``valid`` subset of ``objs``
    (n, k).  Boundary points (per-objective min/max among valid rows) get
    +inf; invalid rows get 0.  Leading lane axes ((L, n, k) and (L, n))
    give one distance vector per lane."""
    n, k = objs.shape[-2:]
    lead = objs.shape[:-2]
    dev = objs.device
    nv = valid.sum(-1)[..., None, None]                     # (..., 1, 1)
    c = torch.where(valid[..., None], objs.to(F), torch.inf)  # invalid last
    order = torch.argsort(c, dim=-2, stable=True)           # (..., n, k)
    s = c.gather(-2, order)
    lo = s[..., :1, :]
    hi = s.gather(-2, (nv - 1).clamp(0, n - 1).expand(*lead, 1, k))
    rng = (hi - lo).clamp_min(1e-12)
    prev = torch.cat([s[..., :1, :], s[..., :-1, :]], -2)
    nxt = torch.cat([s[..., 1:, :], s[..., -1:, :]], -2)
    i = torch.arange(n, device=dev)[:, None]
    gap = (nxt - prev) / rng
    gap = torch.where((i == 0) | (i == nv - 1), torch.inf, gap)
    gap = torch.where(i < nv, gap, 0.0)
    cd = torch.zeros_like(gap).scatter_(-2, order, gap)
    out = cd[..., 0]
    for j in range(1, k):
        out = out + cd[..., j]
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
    round-trip.  ``points`` (L, m, 2) with ``valid`` (L, m) gives one
    hypervolume per lane, (L,)."""
    pts = points.to(F)
    if pts.dim() < 3:
        pts = pts.reshape(-1, 2)
    ref = torch.as_tensor(ref, dtype=F, device=pts.device).reshape(2)
    ok = torch.isfinite(pts).all(-1) & (pts < ref).all(-1)
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    x = torch.where(ok, pts[..., 0], ref[0])
    y = torch.where(ok, pts[..., 1], ref[1])
    order = torch.argsort(x, dim=-1, stable=True)
    xs, ys = x.gather(-1, order), y.gather(-1, order)
    # running staircase minimum BEFORE each point (ref height to start)
    ymin_prev = torch.cat([ref[1:2].expand(*ys.shape[:-1], 1),
                           torch.cummin(ys, -1).values[..., :-1]], -1)
    return ((ref[0] - xs) * (ymin_prev - ys).clamp_min(0.0)).sum(-1)


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

    @classmethod
    def from_history(cls, history: Sequence, evals_per_step: int = 1,
                     objectives: Sequence[str] = ("objective",)
                     ) -> "ConvergenceTrace":
        """Adapt a scalarized engine's ``(iteration, best)`` history (the
        BO x SA loop tracks one incumbent, so ``front_size`` is 1 and there
        are no hypervolume pairs); non-integer tags are skipped."""
        vals = [float(v) for i, v in history
                if isinstance(i, (int, np.integer))]
        g = len(vals)
        best = (np.minimum.accumulate(np.asarray(vals, np.float64))
                if g else np.zeros(0))
        return cls(objectives=tuple(objectives), pairs=(),
                   front_size=np.ones(g, np.int64),
                   hypervolume=np.zeros((g, 0)),
                   best=best, feasible_frac=np.ones(g),
                   n_evals=(np.arange(g, dtype=np.int64) + 1)
                   * int(evals_per_step))

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


def flatten_design(design: Dict) -> torch.Tensor:
    """One design (arrays or tensors) -> a flat float32 feature vector,
    leaves raveled in canonical sorted-key order: the layout of
    ``ParetoArchive.export_rows``."""
    return torch.cat([torch.as_tensor(design[k]).reshape(-1).to(F)
                      for k in sorted(design)])


def flatten_rows(designs: Dict) -> torch.Tensor:
    """A population of designs (leaves with a leading row axis) -> the
    (n, D) float32 ``flatten_design`` encodings of its rows."""
    n = next(iter(designs.values())).shape[0]
    return torch.cat([designs[k].reshape(n, -1).to(F)
                      for k in sorted(designs)], dim=1)


def design_encoding_dim(template: Dict) -> int:
    """Length of ``flatten_design`` output for one design template."""
    return int(sum(int(np.prod(np.shape(v))) for v in template.values()))


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

    def merge(self, other: "ParetoArchive") -> "ParetoArchive":
        """Fold another archive of the SAME problem into this one — the
        reload-under-lock half of the shared-cache write path: a writer
        about to ``save`` merges what a peer process put on disk since it
        last loaded, so concurrent refinements union instead of
        last-``os.replace``-wins.

        Only rows not already present are inserted (exact objective-row
        bytes), through ``insert`` on this archive's device with
        ``count_evals=False``: the peer counted its own evaluations.
        Counters take the element-wise max, ``searched`` the union."""
        if set(other.designs) != set(self.designs):
            raise ValueError("cannot merge archives of different design "
                             "templates")
        have = {r.tobytes()
                for r in self.objs[self.valid].cpu().numpy()}
        o_objs = other.objs.cpu().numpy()
        sel = [int(i) for i in np.flatnonzero(other.valid.cpu().numpy())
               if o_objs[i].tobytes() not in have]
        if sel:
            idx = torch.as_tensor(sel, device=other.objs.device)
            self.insert({k: v[idx] for k, v in other.designs.items()},
                        other.objs[idx], count_evals=False)
        self.n_evals = max(self.n_evals, other.n_evals)
        self.budget_covered = max(self.budget_covered, other.budget_covered)
        self.searched = tuple(sorted(set(self.searched)
                                     | set(other.searched)))
        if not self.trace_summary:
            self.trace_summary = dict(other.trace_summary)
        return self

    def export_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Training rows of this archive: ``(X, Y)`` with ``X`` the (n, D)
        float32 ``flatten_design`` encodings of the valid rows and ``Y``
        their (n, n_obj) float64 raw metrics; an empty archive exports
        ``(0, D)`` / ``(0, n_obj)``."""
        D = design_encoding_dim({k: v[0] for k, v in self.designs.items()})
        sel = torch.nonzero(self.valid).flatten()
        if not len(sel):
            return (np.zeros((0, D), np.float32),
                    np.zeros((0, self.n_obj), np.float64))
        X = flatten_rows({k: v[sel] for k, v in self.designs.items()})
        return (X.cpu().numpy(),
                self.objs[sel].cpu().numpy().astype(np.float64))

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
        with obs.span("archive.save", key=Path(path).stem,
                      n_front=len(self)):
            return atomic_savez(
                path, __meta=np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8),
                objs=self.objs.cpu().numpy(),
                valid=self.valid.cpu().numpy(),
                **{f"d_{k}": v.cpu().numpy()
                   for k, v in self.designs.items()})

    @classmethod
    def load(cls, path, device="cuda") -> "ParetoArchive":
        """Load an archive npz (the port's or the reference's) onto
        ``device``."""
        with obs.span("archive.load", key=Path(path).stem), \
                np.load(Path(path)) as z:
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



# ---------------------------------------------------------------------------
# cross-spec archive manifest: the nearest-neighbor index over every cached
# exploration problem, keyed by workload-feature embedding
# ---------------------------------------------------------------------------
MANIFEST_NAME = "manifest.npz"


@dataclasses.dataclass(frozen=True)
class ManifestPolicy:
    """Growth policy of the manifest index.

    ``max_entries`` bounds the index: past it, the least-recently-used
    entry (lowest ``last_used`` tick) is evicted — the index entry only;
    its archive npz stays on disk.  ``dedup_radius`` > 0 merges entries
    whose embeddings are within that Euclidean distance (the
    better-explored twin survives).  ``max_trust_records`` bounds the
    transfer-outcome table (oldest dropped first).  ``reap_evicted_after``
    > 0 deletes the archive npz of an entry that stayed evicted for that
    many LRU ticks (at the next ``reap_evicted`` sweep)."""
    max_entries: int = 64
    dedup_radius: float = 0.0
    max_trust_records: int = 256
    reap_evicted_after: int = 0


@dataclasses.dataclass(frozen=True)
class TrustModel:
    """Ridge regression ``lift ~ w0 + w . |embedding delta|`` over recorded
    transfer outcomes.  ``predict`` returns the expected lift for a
    candidate (src, dst) pair, clamped at 0."""
    weights: np.ndarray                # (D + 1,) intercept first

    def predict(self, delta) -> float:
        d = np.abs(np.asarray(delta, np.float64).ravel())
        if d.shape[0] + 1 != self.weights.shape[0]:
            return 0.0                 # embedding layout drifted: neutral
        return float(max(self.weights[0] + self.weights[1:] @ d, 0.0))


def fit_trust_model(records: Sequence[Dict], dim: Optional[int] = None,
                    ridge: float = 1.0,
                    min_records: int = 3) -> Optional[TrustModel]:
    """Fit a ``TrustModel`` over transfer-outcome records (dicts with
    ``delta`` (D,) and ``lift``).  Records whose delta dimension differs
    from ``dim`` (default: the modal dimension, the freshest layout winning
    ties) are skipped; fewer than ``min_records`` usable records yield
    ``None``."""
    usable = [r for r in records
              if np.all(np.isfinite(np.asarray(r["delta"], np.float64)))
              and np.isfinite(r["lift"])]
    if not usable:
        return None
    if dim is None:
        sizes = [np.asarray(r["delta"]).size for r in usable]
        counts: Dict[int, int] = {}
        for sz in sizes:
            counts[sz] = counts.get(sz, 0) + 1
        dim = max(counts, key=lambda sz: (counts[sz],
                                          max(i for i, x in enumerate(sizes)
                                              if x == sz)))
    kept = [r for r in usable if np.asarray(r["delta"]).size == dim]
    if len(kept) < len(usable):
        obs.inc("explore.trust.skipped_records", len(usable) - len(kept))
    usable = kept
    if len(usable) < max(int(min_records), 1):
        return None
    X = np.stack([np.concatenate(
        [[1.0], np.abs(np.asarray(r["delta"], np.float64).ravel())])
        for r in usable])
    y = np.asarray([float(r["lift"]) for r in usable])
    A = X.T @ X + ridge * np.eye(X.shape[1])
    A[0, 0] -= ridge                   # don't shrink the intercept
    try:
        w = np.linalg.solve(A, X.T @ y)
    except np.linalg.LinAlgError:
        return None
    return TrustModel(weights=w)


class ArchiveManifest:
    """Index of an explore cache directory: one entry per archived problem
    key, carrying the problem's workload-feature embedding, its padded
    dims, freshness counters, an LRU ``last_used`` tick and a JSON-portable
    space digest (what ``core.encoding.migrate`` needs to move designs OUT
    of that archive).  A ``ManifestPolicy`` bounds growth, and a trust
    table of per-(src, dst) transfer outcomes feeds ``fit_trust_model``.

    ``nearest(embedding, k)`` ranks cached problems by Euclidean distance
    in embedding space, optionally reweighted by a ``TrustModel``.  The
    file is the reference's (one atomically written npz, ``__meta`` JSON
    plus one ``emb_<i>`` array per entry; the stacked pre-v2 layout loads
    too); a damaged file loads as an empty manifest, with a warning."""

    def __init__(self, path=None, policy: ManifestPolicy = ManifestPolicy()):
        self.path = Path(path) if path is not None else None
        self.policy = policy
        self.entries: Dict[str, Dict] = {}
        self.trust: List[Dict] = []    # per-(src, dst) transfer outcomes
        self.clock = 0                 # monotone LRU tick
        self.evicted: Dict[str, int] = {}   # key -> tick it left the index

    def __len__(self) -> int:
        return len(self.entries)

    def _tick(self) -> int:
        self.clock += 1
        return self.clock

    def touch(self, key: str):
        """Mark one entry as just used."""
        if key in self.entries:
            self.entries[key]["last_used"] = self._tick()
        return self

    def update(self, key: str, embedding, dims: Tuple[int, int, int],
               n_evals: int, budget_covered: int,
               searched: Sequence[str], digest: Optional[Dict] = None):
        """Insert or refresh one problem's entry (the previous digest kept
        when not re-supplied), then enforce the growth policy; the entry
        being written is never the one evicted or merged away."""
        prev = self.entries.get(key, {})
        self.evicted.pop(key, None)
        self.entries[key] = dict(
            embedding=np.asarray(embedding, np.float64),
            dims=tuple(int(v) for v in dims),
            n_evals=int(n_evals), budget_covered=int(budget_covered),
            searched=tuple(searched),
            digest=digest if digest is not None else prev.get("digest"),
            last_used=self._tick())
        self.enforce(protect=(key,))
        return self

    # ---- growth policy -----------------------------------------------------
    def enforce(self, protect: Sequence[str] = ()):
        """Dedup first, then LRU eviction down to ``max_entries``;
        ``protect`` keys are never removed."""
        self.dedup(protect=protect)
        prot = set(protect)
        while len(self.entries) > max(int(self.policy.max_entries), 1):
            victims = [k for k in self.entries if k not in prot]
            if not victims:
                break
            victim = min(victims, key=lambda k: (
                self.entries[k].get("last_used", 0), k))
            del self.entries[victim]
            self.evicted[victim] = self.clock
            obs.inc("explore.manifest.evictions")
        return self

    def reap_evicted(self, cache_dir=None) -> Tuple[str, ...]:
        """Opt-in archive-file GC (``policy.reap_evicted_after`` > 0):
        delete the npz of every key that left the index at least that many
        ticks ago and was never re-indexed.  Returns the reaped keys."""
        after = int(self.policy.reap_evicted_after)
        if after <= 0 or not self.evicted:
            return ()
        root = Path(cache_dir) if cache_dir is not None else (
            self.path.parent if self.path is not None else None)
        if root is None:
            return ()
        reaped = []
        for key, tick in list(self.evicted.items()):
            if key in self.entries:
                self.evicted.pop(key)
                continue
            if self.clock - int(tick) < after:
                continue
            (root / f"{key}.npz").unlink(missing_ok=True)
            self.evicted.pop(key)
            reaped.append(key)
        return tuple(reaped)

    def _survivor(self, a: str, b: str, protect: Sequence[str]) -> str:
        """Which of two near-identical entries survives a merge: protected
        keys, then the better-explored one, ties broken on the key — so
        merging is commutative."""
        if (a in protect) != (b in protect):
            return a if a in protect else b
        score = lambda k: (self.entries[k]["n_evals"],
                           self.entries[k]["budget_covered"], k)
        return max((a, b), key=score)

    def dedup(self, protect: Sequence[str] = ()):
        """Merge entries whose embeddings lie within ``dedup_radius``: the
        survivor keeps its key/embedding/digest and absorbs the max of the
        counters and the union of the searched objectives.  Key-sorted
        pairs with a symmetric survivor rule: idempotent and commutative."""
        radius = float(self.policy.dedup_radius)
        if radius <= 0 or len(self.entries) < 2:
            return self
        keys = sorted(self.entries)
        gone: set = set()
        for i, a in enumerate(keys):
            if a in gone:
                continue
            for b in keys[i + 1:]:
                if a in gone:
                    break
                if b in gone:
                    continue
                ea, eb = self.entries[a], self.entries[b]
                if ea["embedding"].shape != eb["embedding"].shape:
                    continue
                if np.linalg.norm(ea["embedding"]
                                  - eb["embedding"]) > radius:
                    continue
                keep = self._survivor(a, b, protect)
                drop = b if keep == a else a
                ek, ed = self.entries[keep], self.entries[drop]
                ek["n_evals"] = max(ek["n_evals"], ed["n_evals"])
                ek["budget_covered"] = max(ek["budget_covered"],
                                           ed["budget_covered"])
                ek["searched"] = tuple(sorted(
                    set(ek["searched"]) | set(ed["searched"])))
                ek["last_used"] = max(ek.get("last_used", 0),
                                      ed.get("last_used", 0))
                gone.add(drop)
        for k in gone:
            del self.entries[k]
            self.evicted[k] = self.clock
            obs.inc("explore.manifest.dedup_merges")
        return self

    def merge(self, other: "ArchiveManifest") -> "ArchiveManifest":
        """Fold another manifest into this one (typically ``self`` is the
        copy just re-read from disk under the lock and ``other`` this
        process's pending state): entries union by key (counters and LRU
        tick take the max, ``searched`` the union), trust records union
        without duplicates, the max clock wins.  Enforcing the growth
        policy is the caller's job."""
        for key, e in other.entries.items():
            mine = self.entries.get(key)
            if mine is None:
                self.entries[key] = dict(
                    e, embedding=np.asarray(e["embedding"], np.float64),
                    searched=tuple(e["searched"]))
                continue
            mine["n_evals"] = max(mine["n_evals"], e["n_evals"])
            mine["budget_covered"] = max(mine["budget_covered"],
                                         e["budget_covered"])
            mine["searched"] = tuple(sorted(set(mine["searched"])
                                            | set(e["searched"])))
            mine["last_used"] = max(mine.get("last_used", 0),
                                    e.get("last_used", 0))
            if mine.get("digest") is None:
                mine["digest"] = e.get("digest")
        seen = {(r["src"], r["dst"], r["lift"], r["delta"].tobytes())
                for r in self.trust}
        for r in other.trust:
            ident = (r["src"], r["dst"], r["lift"], r["delta"].tobytes())
            if ident not in seen:
                seen.add(ident)
                self.trust.append(dict(r))
        keep = max(int(self.policy.max_trust_records), 1)
        if len(self.trust) > keep:
            self.trust = self.trust[-keep:]
        self.clock = max(self.clock, other.clock)
        for k, t in other.evicted.items():
            self.evicted[k] = max(self.evicted.get(k, 0), int(t))
        for k in list(self.evicted):
            if k in self.entries:
                del self.evicted[k]
        return self

    # ---- trust table -------------------------------------------------------
    def record_transfer(self, src: str, dst: str, delta, lift: float):
        """Append one observed transfer outcome: seeds from ``src`` in
        ``dst``'s run, embeddings differing by ``delta``, with ``lift``
        the run's front-loadedness.  Oldest records roll off."""
        self.trust.append(dict(
            src=str(src), dst=str(dst),
            delta=np.asarray(delta, np.float64).ravel(),
            lift=float(lift)))
        keep = max(int(self.policy.max_trust_records), 1)
        if len(self.trust) > keep:
            self.trust = self.trust[-keep:]
        return self

    def export_index(self, exclude: Sequence[str] = ()
                     ) -> List[Tuple[str, np.ndarray]]:
        """``(key, embedding)`` for every indexed problem with paid
        evaluations and a digest, sorted by key, minus ``exclude``."""
        skip = set(exclude)
        return [(k, e["embedding"]) for k, e in sorted(self.entries.items())
                if k not in skip and e["n_evals"] > 0
                and e.get("digest") is not None]

    def trust_model(self, dim: Optional[int] = None):
        """The fitted trust model over this manifest's recorded outcomes
        (``None`` until enough records accumulate).  With a deep record
        table (>= ``surrogate.NONLINEAR_TRUST_MIN``) the non-linear MLP
        head takes over from the ridge ``TrustModel`` (same ``predict(delta)
        -> lift >= 0`` contract); the ridge fit stays the answer whenever
        the MLP cannot be fit."""
        from .surrogate import NONLINEAR_TRUST_MIN, fit_nonlinear_trust
        if len(self.trust) >= NONLINEAR_TRUST_MIN:
            tm = fit_nonlinear_trust(self.trust, dim=dim)
            if tm is not None:
                return tm
        return fit_trust_model(self.trust, dim=dim)

    def nearest(self, embedding, k: int = 3,
                exclude: Sequence[str] = (),
                trust: Optional[TrustModel] = None
                ) -> List[Tuple[str, float]]:
        """The ``k`` cached problems closest to ``embedding`` (ascending
        distance), skipping excluded keys, empty archives and mismatched
        embedding dimensions; with ``trust``, each distance is divided by
        ``1 + max(predicted lift, 0)``.  Ties break on key."""
        q = np.asarray(embedding, np.float64).ravel()
        out = []
        for key, e in self.entries.items():
            if key in exclude or e["n_evals"] <= 0:
                continue
            emb = e["embedding"]
            if emb.shape != q.shape:
                continue
            dist = float(np.linalg.norm(emb - q))
            if trust is not None:
                dist = dist / (1.0 + max(trust.predict(q - emb), 0.0))
            out.append((key, dist))
        out.sort(key=lambda t: (t[1], t[0]))
        return out[:max(int(k), 0)]

    # ---- persistence -------------------------------------------------------
    def save(self, path=None) -> Path:
        path = Path(path) if path is not None else self.path
        if path is None:
            raise ValueError("manifest has no path")
        keys = sorted(self.entries)
        meta = dict(
            version=3,
            keys=keys,
            clock=int(self.clock),
            evicted={k: int(t) for k, t in self.evicted.items()},
            entries={k: dict(
                dims=list(self.entries[k]["dims"]),
                n_evals=self.entries[k]["n_evals"],
                budget_covered=self.entries[k]["budget_covered"],
                searched=list(self.entries[k]["searched"]),
                last_used=int(self.entries[k].get("last_used", 0)),
                digest=self.entries[k]["digest"]) for k in keys},
            trust=[dict(src=r["src"], dst=r["dst"], lift=r["lift"],
                        delta=[float(v) for v in r["delta"]])
                   for r in self.trust])
        # one array per entry: entries of different embedding layouts save
        # side by side
        emb = {f"emb_{i}": np.asarray(self.entries[k]["embedding"],
                                      np.float64)
               for i, k in enumerate(keys)}
        return atomic_savez(
            path, __meta=np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8),
            **emb)

    @classmethod
    def load(cls, path,
             policy: ManifestPolicy = ManifestPolicy()) -> "ArchiveManifest":
        """Load a manifest, tolerating absence and damage (an unreadable
        file yields an EMPTY manifest with a warning).  Files without LRU
        ticks or a trust table load with zeroed ``last_used`` and an empty
        table.  This reader's policy is enforced at once."""
        path = Path(path)
        m = cls(path, policy=policy)
        if not path.exists():
            return m
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["__meta"]).decode())
                if "embeddings" in z.files:     # stacked pre-v2 layout
                    stacked = np.asarray(z["embeddings"], np.float64)
                    emb = [stacked[i] for i in range(len(meta["keys"]))]
                else:
                    emb = [np.asarray(z[f"emb_{i}"], np.float64)
                           for i in range(len(meta["keys"]))]
            for i, k in enumerate(meta["keys"]):
                e = meta["entries"][k]
                m.entries[k] = dict(
                    embedding=emb[i],
                    dims=tuple(e["dims"]),
                    n_evals=int(e["n_evals"]),
                    budget_covered=int(e["budget_covered"]),
                    searched=tuple(e["searched"]),
                    digest=e.get("digest"),
                    last_used=int(e.get("last_used", 0)))
            m.clock = int(meta.get("clock", 0))
            m.evicted = {str(k): int(t)
                         for k, t in meta.get("evicted", {}).items()}
            m.trust = [dict(src=r["src"], dst=r["dst"],
                            delta=np.asarray(r["delta"], np.float64),
                            lift=float(r["lift"]))
                       for r in meta.get("trust", [])]
        except Exception as exc:        # a disposable index: never fatal
            warnings.warn(f"discarding unreadable explore manifest "
                          f"{path}: {exc}")
            m.entries = {}
            m.trust = []
            m.clock = 0
            m.evicted = {}
        m.enforce()
        return m
