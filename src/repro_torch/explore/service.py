"""The exploration *service*: the NSGA engine backend behind
``repro_torch.api.Session.submit`` — the port of ``repro.explore.service``:

* **Archive cache** — before spending compute, the service consults the
  per-problem ``ParetoArchive`` (in memory, then on disk under
  ``cache_dir``).  A query whose budget and objectives are already covered
  is answered straight from the archive (``warm_verdict``): no evaluator.
* **Warm starts** — when compute IS needed, the initial population is
  seeded from the cached front (topped up with ``random_design`` samples).
* **Query batching** — same-problem queries of one batch merge into ONE run
  over the union of their objectives and the max of their budgets; each
  query projects its own front out of the shared archive.
* **Adaptive budgets** (``BudgetPolicy``) — a budget is spent in quantized
  scan *segments*; once the archive-projected hypervolume of every queried
  objective pair improved by less than ``plateau_rel`` for ``patience``
  segments, refinement stops early and the unspent evaluations are banked
  in the per-problem ledger, which ``reallocate`` spends on the batch's
  still-improving groups.
* **Cross-workload transfer** — ``transfer=True`` seeds cold starts and
  budget-increase refinements from the migrated fronts of the nearest
  cached neighbors (``ArchiveManifest.nearest``, trust-reweighted once the
  manifest's outcome table supports a fit); seeds that duplicate the
  destination's own front are dropped, a cold start with no neighbor gets
  one ``balanced_init`` design, and every seeded run books its observed
  hypervolume lift into the trust table.
* **A fleet-shared cache** — archive and manifest writes run lock → reload
  → merge → replace under ``locks.file_lock``, so services in several
  processes pointed at one directory union their results.
* **Resume** — ``run_queries(resume=True)`` checkpoints every segment
  beside the archive; a stopped (``RunControl``) or killed run re-submitted
  with the same queries and key restores the last completed segment and
  lands on the bit-identical front.
* **Megabatching** (``BudgetPolicy.megabatch``, on by default) — cold,
  distinct problems of one padded shape and one segment schedule run as
  the lanes of one ``make_nsga_fused`` run (lane counts pow2-padded, at
  most ``megabatch_lanes``); every lane books its archive, trace, plateau
  and bank exactly as its sequential run would, and answers with the same
  front.
* **Surrogate gating** (``ExploreQuery.surrogate``) — an ensemble MLP fit
  on every other cached archive's rows ranks each generation's children,
  and only ``SurrogateConfig.n_exact`` of them are evaluated exactly
  (``make_nsga_gated``); a segment whose mean ensemble disagreement
  exceeds ``fallback_tau`` abandons the gate for the rest of the run.
  With too few rows to fit, the query runs the exact path bit for bit.

Archives live on the service's device and every insert runs there.  The
archive cache key and the checkpoint signature are salted with
``CACHE_SALT``, so the port and the reference never share an archive file
or a checkpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import threading
import time
import warnings
import zipfile
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.constants import DEFAULT_TECH, TechConstants, tech_key
from ..core.encoding import (DesignSpace, balanced_init, migrate,
                             portable_signature, random_design, repair,
                             space_digest)
from ..core.evaluate import SystemSpec
from ..core.optimizer import METRIC_KEYS
from ..core.presets import resolve_tech
from ..core.workload import (WorkloadGraph, embedding_delta,
                             workload_features)
from ..runtime import fold_in, resolve_device
from . import quantize
from .archive import (MANIFEST_NAME, ArchiveManifest, ConvergenceTrace,
                      ManifestPolicy, ParetoArchive, atomic_savez,
                      design_encoding_dim, objective_pairs, pareto_front,
                      spec_space_key)
from .locks import LockTimeout, file_lock, lock_path
from .nsga import (ISLAND_AXIS, NSGAConfig, island_count, make_nsga,
                   make_nsga_fused, make_nsga_gated)
from .surrogate import (Surrogate, SurrogateConfig, fit_surrogate,
                        harvest_rows)

# the default archive cache is anchored to the repo root (four levels above
# this file: src/repro_torch/explore/service.py), NOT the process CWD
DEFAULT_CACHE_DIR = (Path(__file__).resolve().parents[3]
                     / "artifacts" / "explore_cache")
DEFAULT_OBJECTIVES = ("latency_ns", "cost_usd")
# folded into every archive key and checkpoint signature: the port's
# evaluator never serves a front, nor resumes a run, the reference wrote
CACHE_SALT = "repro_torch"


def resolve_cache_dir(cache_dir=None) -> Path:
    """The cache directory a service will really use, validated: an
    explicit ``cache_dir`` wins, then ``$REPRO_EXPLORE_CACHE``, then
    ``$REPRO_CACHE_DIR``, then the repo-anchored default."""
    p = Path(cache_dir
             or os.environ.get("REPRO_EXPLORE_CACHE")
             or os.environ.get("REPRO_CACHE_DIR")
             or DEFAULT_CACHE_DIR).expanduser()
    try:
        p.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise ValueError(f"explore cache directory {p} is unusable: {e}") \
            from e
    if not os.access(p, os.W_OK):
        raise ValueError(f"explore cache directory {p} is not writable")
    return p


def _transfer_lift(trace: ConvergenceTrace) -> float:
    """Front-loadedness of one seeded run, in [0, 1]: the mean of the
    per-generation front hypervolume (``hv_gen``) normalized into the run's
    own [min, max] range.  A flat trajectory records a neutral 0.5."""
    hv = trace.hv_gen if trace.hv_gen is not None else trace.hypervolume
    if hv is None or hv.size == 0:
        return 0.0
    col = np.asarray(hv[:, 0], np.float64)
    lo, hi = float(col.min()), float(col.max())
    if hi - lo <= 1e-9 * max(abs(hi), 1.0):
        return 0.5
    return float(np.clip(np.mean((col - lo) / (hi - lo)), 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class BudgetPolicy:
    """How a query's evaluation budget is spent (see the reference's
    ``BudgetPolicy``).  ``chunk_generations`` splits the NSGA run into
    segments of that many generations (quantized to a power of two); with
    ``adaptive`` on, refinement stops once EVERY queried objective pair's
    archive-projected hypervolume improved by less than ``plateau_rel``
    for ``patience`` consecutive segments, banking the rest.
    ``reallocate`` spends banked credit on the batch's under-explored,
    still-improving archives.  ``megabatch`` lets ``run_queries`` fuse
    DIFFERENT cold problems of one padded shape and one schedule into the
    lanes of one run (lane counts pow2-padded, at most
    ``megabatch_lanes``); a query opts out with
    ``ExploreQuery.megabatch=False``, and ``resume`` never fuses
    (checkpoints stay per group)."""
    chunk_generations: int = 8
    plateau_rel: float = 0.005
    patience: int = 2
    adaptive: bool = True
    reallocate: bool = True
    megabatch: bool = True
    megabatch_lanes: int = 8


@dataclasses.dataclass
class PlateauState:
    """The plateau detector's memory across the scan segments refining
    ONE archive: the previous segment's archive-projected hypervolume
    vector and the current below-threshold streak.  Held per problem group,
    so a resumed run continues the streak where the stopped one left it;
    ``reset`` forgets it when a reallocation top-up grants fresh budget."""
    last_hv: Optional[np.ndarray] = None
    streak: int = 0

    def observe(self, hv_now, rel_tol: float, count: bool = True) -> int:
        """Record one segment's hypervolume vector and return the updated
        streak.  ``count=False`` records the vector without judging it
        (an empty archive is stagnation, not convergence)."""
        hv_now = np.asarray(hv_now, np.float64)
        if (count and self.last_hv is not None
                and self.last_hv.shape == hv_now.shape):
            rel = (hv_now - self.last_hv) / np.maximum(
                np.abs(self.last_hv), 1e-9)
            self.streak = self.streak + 1 if np.all(rel < rel_tol) else 0
        self.last_hv = hv_now
        return self.streak

    def reset(self) -> "PlateauState":
        self.last_hv = None
        self.streak = 0
        return self


class RunControl:
    """Cooperative stop token for a running submission.  ``stop()`` (from
    any thread, or from an ``on_segment`` callback) makes the engine break
    at the NEXT segment boundary: the segment in flight completes, the
    resume checkpoint stays on disk, and the results carry
    ``interrupted=True`` with ``budget_covered`` NOT bumped."""

    __slots__ = ("_stop",)

    def __init__(self):
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()


@dataclasses.dataclass
class ExploreQuery:
    """One front request (the service-level form of ``api.Query``).
    ``spec``/``space`` optionally carry a prebuilt problem."""
    graph: WorkloadGraph
    objectives: Tuple[str, ...] = DEFAULT_OBJECTIVES
    budget: int = 2048              # total design evaluations (cold)
    ch_max: int = 4
    space_kwargs: Optional[Dict] = None
    transfer: bool = False          # seed from migrated neighbor fronts
    spec: Optional[SystemSpec] = None
    space: Optional[DesignSpace] = None
    megabatch: bool = True          # allow this query's group to fuse with
    #                                 other problems (BudgetPolicy.megabatch)
    surrogate: Optional[Dict] = None    # surrogate-gated evaluation: None
    #                                 (the exact path), or a dict of
    #                                 ``SurrogateConfig`` overrides (``True``
    #                                 normalizes to ``{}``); an extra
    #                                 ``"exclude"`` key lists archive keys
    #                                 held out of training.  With too few
    #                                 training rows the query runs exact,
    #                                 bit-identical to surrogate=None

    def __post_init__(self):
        self.objectives = tuple(self.objectives)
        if not self.objectives:
            raise ValueError("at least one objective required")
        bad = [o for o in self.objectives if o not in METRIC_KEYS]
        if bad:
            raise ValueError(f"unknown objectives {bad}; pick from "
                             f"{METRIC_KEYS}")
        if self.surrogate is True:
            self.surrogate = {}
        if self.surrogate is not None and not isinstance(self.surrogate,
                                                         dict):
            raise ValueError("surrogate must be None, True or a dict of "
                             "SurrogateConfig overrides")

    def build(self) -> Tuple[SystemSpec, DesignSpace]:
        """This query's (spec, space), built on demand and memoized."""
        if self.spec is None:
            self.spec = SystemSpec.build(self.graph, ch_max=self.ch_max)
        if self.space is None:
            self.space = DesignSpace(self.spec, **(self.space_kwargs or {}))
        return self.spec, self.space


@dataclasses.dataclass(frozen=True)
class SegmentEvent:
    """One streamed scan-segment boundary: the archive ``cache_key``, the
    segment index within its phase, the segment's incremental
    ``ConvergenceTrace`` slice, the phase (``"refine"``, ``"realloc"`` or a
    scalarized engine's name), its wall-clock and a stream-monotone
    ``seq``."""
    cache_key: str
    segment: int
    trace: ConvergenceTrace
    phase: str = "refine"
    elapsed_s: float = 0.0
    seq: int = 0


@dataclasses.dataclass
class ExploreResult:
    objectives: Tuple[str, ...]
    front_objs: np.ndarray          # (n, len(objectives)) nondominated rows
    front_metrics: np.ndarray       # (n, 4) full METRIC_KEYS rows
    front_designs: List[Dict[str, np.ndarray]]
    from_cache: bool                # True => served without any evaluation
    n_evals_run: int                # evaluations spent by the group's run
    elapsed_s: float                # wall time of the group's answer
    cache_key: str
    trace: Optional[ConvergenceTrace] = None    # per-generation telemetry
    plateaued: bool = False         # hypervolume plateau => stopped early
    n_evals_banked: int = 0         # evaluations banked by the early stop
    n_evals_realloc: int = 0        # extra evaluations from banked credit
    transferred_from: Tuple[str, ...] = ()      # neighbor archive keys whose
    #                                 migrated fronts seeded this run
    n_transfer_seeds: int = 0       # seeds injected (migrated or balanced)
    interrupted: bool = False       # a RunControl stop ended the run early
    surrogate_used: bool = False    # a fleet surrogate gated the group's
    #                                 evaluations (False when not asked for
    #                                 or when the cache was too cold to fit)
    surrogate_hits: int = 0         # candidate evaluations the gate skipped
    surrogate_fallbacks: int = 0    # 1 when ensemble disagreement abandoned
    #                                 the surrogate mid-run


@dataclasses.dataclass
class SurrogateGate:
    """A fitted fleet surrogate bound to one group's workload embedding —
    everything ``_refine`` needs to gate a refinement's evaluations."""
    model: Surrogate
    embedding: np.ndarray
    cfg: SurrogateConfig


class ExplorationService:
    """Holds per-problem archives (memory + disk, on ``device``), the
    cache directory's manifest, and runs the NSGA engine on ``device``.
    ``ledger`` maps problem key -> evaluations banked by plateau early
    stops.  ``tech`` is a ``TechConstants``, a preset name or artifact path,
    or a calibrated tech (see ``core.presets.resolve_tech``)."""

    def __init__(self, cache_dir=None, capacity: int = 256,
                 nsga: NSGAConfig = NSGAConfig(), tech=None,
                 policy: BudgetPolicy = BudgetPolicy(),
                 transfer_k: int = 3,
                 manifest_policy: ManifestPolicy = ManifestPolicy(),
                 device="cuda", mesh=None):
        # ``mesh`` (``launch.mesh.make_island_mesh``) runs every
        # refinement's population as island-model NSGA (see make_nsga);
        # a quantized population too small to split runs the plain loop,
        # and megabatching and surrogate gating are off while a mesh is
        # set (the layouts are mutually exclusive, as in the reference)
        self.device = resolve_device(device)
        self.mesh = mesh
        if tech is not None and not isinstance(tech, TechConstants):
            _, tech = resolve_tech(tech)
        self.cache_dir = resolve_cache_dir(cache_dir)
        self.capacity = int(capacity)
        self.nsga = nsga
        self.tech = tech
        self.policy = policy
        self.transfer_k = int(transfer_k)
        self.manifest_policy = manifest_policy
        self.ledger: Dict[str, int] = {}
        self._archives: Dict[str, ParetoArchive] = {}
        # neighbor archives loaded only to migrate seeds out of: a small
        # LRU side-cache keyed on the npz mtime (stale fronts re-read)
        self._neighbor_cache: \
            "OrderedDict[str, Tuple[int, ParetoArchive]]" = OrderedDict()
        self._neighbor_cache_cap = max(8, 2 * self.transfer_k)
        self._manifest: Optional[ArchiveManifest] = None
        self._manifest_mtime: Optional[int] = None
        # per-key npz mtime at this service's last load/save: a different
        # disk mtime at save time means a peer wrote the archive since
        self._archive_sync: Dict[str, Optional[int]] = {}

    def _manifest_stat(self) -> Optional[int]:
        try:
            return (self.cache_dir / MANIFEST_NAME).stat().st_mtime_ns
        except OSError:
            return None

    @property
    def manifest(self) -> ArchiveManifest:
        """The cache directory's index (lazy-loaded; a damaged or absent
        file is an empty manifest).  The file's mtime is checked on every
        access, so a peer's write invalidates this service's copy.
        Multi-step operations take ONE snapshot and work on it."""
        mtime = self._manifest_stat()
        if self._manifest is None or mtime != self._manifest_mtime:
            if self._manifest is not None:      # a genuine staleness, not
                obs.inc("explore.manifest.reloads")     # the first load
            with obs.span("manifest.reload"):
                self._manifest = ArchiveManifest.load(
                    self.cache_dir / MANIFEST_NAME,
                    policy=self.manifest_policy)
            self._manifest_mtime = mtime
        return self._manifest

    # ---- cache plumbing ----------------------------------------------------
    def _path(self, key: str) -> Path:
        return self.cache_dir / f"{key}.npz"

    def problem_key(self, spec: SystemSpec, space: DesignSpace) -> str:
        """Archive identity for one problem under THIS service's tech,
        salted with ``CACHE_SALT``."""
        return spec_space_key(spec, space, extra=(
            CACHE_SALT, tech_key(self.tech or DEFAULT_TECH)))

    def archive_for(self, spec: SystemSpec, space: DesignSpace,
                    key: Optional[str] = None) -> ParetoArchive:
        """The (possibly empty) archive for one exploration problem —
        memory first, then disk, else freshly created."""
        key = key or self.problem_key(spec, space)
        if key in self._archives:
            return self._archives[key]
        arc = None
        p = self._path(key)
        if p.exists():
            try:
                arc = ParetoArchive.load(p, device=self.device)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                # a cache is disposable: a damaged file never kills a query
                warnings.warn(f"discarding unreadable explore cache {p}: {e}")
                p.unlink(missing_ok=True)
        if arc is None:
            template = random_design(0, space, device=self.device)
            arc = ParetoArchive(self.capacity, template,
                                n_obj=len(METRIC_KEYS), obj_keys=METRIC_KEYS,
                                device=self.device)
        else:
            self._mark_sync(key, p)
        self._archives[key] = arc
        return arc

    def _mark_sync(self, key: str, p: Path) -> None:
        try:
            self._archive_sync[key] = p.stat().st_mtime_ns
        except OSError:
            self._archive_sync.pop(key, None)

    def _merge_disk(self, key: str, arc: ParetoArchive, p: Path) -> None:
        """Fold a peer's on-disk archive state into ``arc`` when the npz
        changed since this service last synced it (unreadable peer state is
        skipped with a warning)."""
        try:
            mt = p.stat().st_mtime_ns
        except OSError:
            return
        if mt == self._archive_sync.get(key):
            return
        try:
            arc.merge(ParetoArchive.load(p, device=self.device))
            self._archive_sync[key] = mt
            obs.inc("explore.archive.merges")
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            warnings.warn(f"could not merge peer archive state {p}: {e}")

    def save(self, key: str):
        """Persist one archive, lock → reload → merge → replace, so
        concurrent refinements of one problem union.  A lock timeout
        degrades to an unmerged save with a warning."""
        arc = self._archives.get(key)
        if arc is None:
            return
        p = self._path(key)
        try:
            with file_lock(lock_path(p)):
                self._merge_disk(key, arc, p)
                arc.save(p)
                self._mark_sync(key, p)
        except LockTimeout as e:
            warnings.warn(f"archive lock busy for {key} ({e}); "
                          f"saving without peer merge")
            arc.save(p)
            self._mark_sync(key, p)

    def refresh_archive(self, spec: SystemSpec, space: DesignSpace,
                        key: Optional[str] = None) -> ParetoArchive:
        """The freshest known archive for one problem: the in-memory copy
        merged with what peer processes have put on disk since."""
        key = key or self.problem_key(spec, space)
        arc = self.archive_for(spec, space, key=key)
        self._merge_disk(key, arc, self._path(key))
        return arc

    def _ckpt_path(self, key: str) -> Path:
        """Where a resumable submission checkpoints mid-run state (one
        atomic npz beside the archive; deleted on normal completion)."""
        return self.cache_dir / f"{key}.ckpt.npz"

    @staticmethod
    def warm_verdict(arc: ParetoArchive, objectives: Sequence[str],
                     budget: int) -> bool:
        """True when ``arc`` can answer a query over ``objectives`` at
        ``budget`` straight from cache: the covered budget and every
        queried objective are covered."""
        return (len(arc) > 0
                and max(arc.n_evals, arc.budget_covered) >= budget
                and all(o in arc.searched for o in objectives))

    # ---- deprecated entry points -------------------------------------------
    def explore(self, graph: WorkloadGraph,
                objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                budget: int = 2048, ch_max: int = 4,
                space_kwargs: Optional[Dict] = None,
                transfer: bool = False, key=None) -> ExploreResult:
        """DEPRECATED shim — routes through ``repro_torch.api.Session.
        submit`` (``Query(Problem(...), engine="nsga")``) and returns the
        ``ExploreResult`` the NSGA backend produced."""
        warnings.warn(
            "legacy entry point ExplorationService.explore() is "
            "deprecated; use repro_torch.api: Session(...).submit(Query("
            "Problem(graph, objectives, ...), budget=..., transfer=...))",
            DeprecationWarning, stacklevel=2)
        from .api import Problem, Query, Session
        q = Query(Problem(graph, objectives=tuple(objectives),
                          ch_max=ch_max, space_kwargs=space_kwargs),
                  budget=budget, engine="nsga", transfer=transfer)
        return Session(service=self).submit(
            q, key=0 if key is None else key).raw

    def explore_batch(self, queries: Sequence[ExploreQuery],
                      key=None) -> List[ExploreResult]:
        """DEPRECATED shim — routes through ``repro_torch.api.Session.
        submit`` with one ``Query`` per ``ExploreQuery``."""
        warnings.warn(
            "legacy entry point ExplorationService.explore_batch() is "
            "deprecated; use repro_torch.api: Session(...).submit("
            "[Query(...), ...])", DeprecationWarning, stacklevel=2)
        from .api import Problem, Query, Session
        qs = [Query(Problem(q.graph, objectives=q.objectives,
                            ch_max=q.ch_max, space_kwargs=q.space_kwargs),
                    budget=q.budget, engine="nsga", transfer=q.transfer)
              for q in queries]
        return [r.raw for r in Session(service=self).submit(
            qs, key=0 if key is None else key)]

    # ---- the query path ----------------------------------------------------
    def run_queries(self, queries: Sequence[ExploreQuery], key: int = 0,
                    on_segment=None, resume: bool = False,
                    control: Optional[RunControl] = None
                    ) -> List[ExploreResult]:
        """Answer a batch of queries, merging same-problem queries into one
        NSGA run (union objectives, max budget), then reallocating banked
        credit (``BudgetPolicy.reallocate``) to the batch's still-improving
        groups, lowest eval-count first.  ``key`` is the integer seed of the
        batch; group ``i`` draws from ``fold_in(key, i)``.  ``on_segment``
        (callable taking one ``SegmentEvent``) streams each segment's
        incremental trace slice as it finishes; a failing callback is
        warned about, counted and journaled, never fatal.  ``resume=True``
        checkpoints every segment and restores a matching checkpoint on
        entry (bit-identical final front); ``control`` (a ``RunControl``)
        stops at the next segment boundary."""
        groups: Dict[str, Dict] = {}
        order: List[Tuple[str, int]] = []      # (cache_key, slot in group)
        for q in queries:
            spec, space = q.build()
            ck = self.problem_key(spec, space)
            g = groups.setdefault(ck, dict(spec=spec, space=space,
                                           queries=[]))
            order.append((ck, len(g["queries"])))
            g["queries"].append(q)
        seq = itertools.count()
        with obs.span("explore.run_queries", queries=len(queries),
                      groups=len(groups)):
            # per-group seeds are fixed by enumeration order before any
            # fusing, so a group's stream — and its front — is the same
            # whether it runs sequentially or as a megabatch lane
            gkeys = {ck: fold_in(key, i) for i, ck in enumerate(groups)}
            fused = set()
            if (self.policy.megabatch and not resume and self.mesh is None
                    and len(groups) > 1):
                fused = self._megabatch_pass(groups, gkeys, on_segment, seq,
                                             control)
            for ck, g in groups.items():
                if ck not in fused:
                    self._refine_group(ck, g, gkeys[ck], on_segment, seq,
                                       resume=resume, control=control)
            if self.policy.reallocate:
                self._reallocate(groups, fold_in(key, len(groups)),
                                 on_segment, seq, control=control)
        group_results = {ck: self._project_group(ck, g)
                         for ck, g in groups.items()}
        return [group_results[ck][slot] for ck, slot in order]

    @staticmethod
    def _segment_cb(on_segment, ck: str, phase: str, seq=None):
        """The ``_refine`` callback for one group and phase: tags each
        segment with the archive key, phase, stream sequence number and the
        segment's wall-clock (read once, at the segment boundary), journals
        one ``segment`` record per boundary, and never lets a callback
        failure kill the query it observes — a failure is warned about with
        its phase and segment, counted (``obs.on_segment_errors``) and
        journaled (``callback_error``).  ``None`` when nobody listens."""
        if on_segment is None and not obs.active():
            return None
        seq = seq if seq is not None else itertools.count()

        def cb(s: int, tr: ConvergenceTrace, elapsed_s: float,
               compiled: bool):
            ev = SegmentEvent(ck, s, tr, phase, elapsed_s=elapsed_s,
                              seq=next(seq))
            if obs.active():
                hv = (tr.archive_hv[-1] if tr.archive_hv is not None
                      and len(tr.archive_hv) else None)
                obs.emit(dict(
                    type="segment", key=ck, phase=phase, segment=s,
                    seq=ev.seq, elapsed_s=elapsed_s, compile=compiled,
                    n_evals=int(tr.n_evals[-1]) if len(tr.n_evals) else 0,
                    front_size=(int(tr.front_size[-1])
                                if len(tr.front_size) else 0),
                    hv=[float(v) for v in hv] if hv is not None else None))
            if on_segment is None:
                return
            try:
                on_segment(ev)
            except Exception as e:      # an observer never fails the query
                obs.inc("obs.on_segment_errors")
                if obs.active():
                    obs.emit(dict(type="callback_error", key=ck,
                                  phase=phase, segment=s, seq=ev.seq,
                                  error=repr(e)))
                warnings.warn(
                    f"on_segment callback failed for {ck} "
                    f"(phase={phase}, segment={s}): {e}")
        return cb

    def _open_group(self, ck: str, g: Dict) -> bool:
        """Resolve the group's archive, record the query facts on ``g`` and
        return the warm verdict (True => served straight from cache).
        Idempotent: the megabatch pass may open a group the sequential
        loop then revisits."""
        if "warm" in g:
            return g["warm"]
        arc = g["arc"] = self.archive_for(g["spec"], g["space"], key=ck)
        g["embedding"] = workload_features(g["spec"].graph)
        budget = g["budget"] = max(q.budget for q in g["queries"])
        union = g["union"] = tuple(
            k for k in METRIC_KEYS
            if any(k in q.objectives for q in g["queries"]))
        warm = self.warm_verdict(arc, union, budget)
        obs.inc("explore.cache.hit" if warm else "explore.cache.miss")
        g.update(warm=warm, n_run=0, trace=None, plateaued=False,
                 banked=0, realloc=0, transferred_from=(), n_seeds=0,
                 interrupted=False, plateau=PlateauState(),
                 # any member asking for gating turns it on for the shared
                 # run (like budget: max wins)
                 surrogate=next((q.surrogate for q in g["queries"]
                                 if q.surrogate is not None), None),
                 sur_used=False, sur_hits=0, sur_fallbacks=0)
        if warm and ck not in self.manifest.entries:
            self._update_manifest(ck, g)     # index caches written before
        return warm

    def _group_seeds(self, ck: str, g: Dict, key: int) -> Optional[Dict]:
        """Transfer seeds for one opened group when any of its queries asked
        for them.  A warm refinement's own front head keeps at least half
        the population."""
        if not any(q.transfer for q in g["queries"]):
            return None
        arc = g["arc"]
        pop_eff = quantize.effective_pop(g["budget"], self.nsga.pop)
        cap = pop_eff if len(arc) == 0 else max(pop_eff // 2, 1)
        with obs.span("explore.transfer_seeds", key=ck):
            seeds, srcs = self._transfer_seeds(
                ck, g["space"], g["embedding"], fold_in(key, 0x7e5),
                arc=arc, cap=cap)
        g["transferred_from"] = srcs
        g["n_seeds"] = (int(next(iter(seeds.values())).shape[0])
                        if seeds else 0)
        return seeds

    def _book_refinement(self, ck: str, g: Dict, sp, n_run: int, trace,
                         plateaued: bool, banked: int,
                         interrupted: bool) -> None:
        """Shared epilogue of one group's refinement (sequential or fused):
        archive accounting, the eval and bank counters, the ledger, trust
        calibration, the archive and manifest writes.  ``sp`` is the
        group's live span (``None`` for a fused lane)."""
        arc, union, budget = g["arc"], g["union"], g["budget"]
        arc.searched = tuple(k for k in METRIC_KEYS
                             if k in arc.searched or k in union)
        if not interrupted:
            # an interrupted run still owes its residual segments
            arc.budget_covered = max(arc.budget_covered, budget)
        obs.inc("explore.evals.spent", n_run)
        if banked:
            obs.inc("explore.evals.banked", banked)
            self.ledger[ck] = self.ledger.get(ck, 0) + banked
        g.update(n_run=n_run, trace=trace, plateaued=plateaued,
                 banked=banked, interrupted=interrupted)
        if sp is not None:
            sp.set(n_run=n_run, plateaued=plateaued, banked=banked,
                   n_seeds=g["n_seeds"], interrupted=interrupted)
        if trace is not None:
            arc.trace_summary = trace.summary()
        self.save(ck)
        m = self.manifest               # ONE snapshot for both updates
        self._record_trust(ck, g, trace, m)
        self._update_manifest(ck, g, m)

    def _refine_group(self, ck: str, g: Dict, key: int, on_segment, seq,
                      resume: bool = False,
                      control: Optional[RunControl] = None) -> None:
        """Serve the group from cache, or spend (or bank) its budget."""
        t0 = time.perf_counter()
        if self._open_group(ck, g):
            g["elapsed"] = time.perf_counter() - t0
            return
        with obs.span("explore.refine_group", key=ck,
                      budget=g["budget"]) as sp:
            seeds = self._group_seeds(ck, g, key)
            ckpt = self._ckpt_path(ck) if resume else None
            gate = None
            if g["surrogate"] is not None:
                # a resumed gated run replays the surrogate it started with
                gate = (self._stored_gate(ckpt, g) if ckpt is not None
                        else None) or self._fit_gate(ck, g)
            n_run, trace, plateaued, banked, interrupted, sstats = \
                self._refine(
                    g["arc"], g["spec"], g["space"], g["union"],
                    g["budget"], key, seeds=seeds,
                    on_segment=self._segment_cb(on_segment, ck, "refine",
                                                seq),
                    plateau=g["plateau"], control=control, checkpoint=ckpt,
                    gate=gate)
            g.update(sur_used=sstats["used"], sur_hits=sstats["hits"],
                     sur_fallbacks=sstats["fallbacks"])
            self._book_refinement(ck, g, sp, n_run, trace, plateaued,
                                  banked, interrupted)
        g["elapsed"] = time.perf_counter() - t0

    # ---- surrogate gating --------------------------------------------------
    @staticmethod
    def _gate_config(g: Dict) -> Tuple[SurrogateConfig, Tuple[str, ...]]:
        opts = dict(g["surrogate"])
        exclude = tuple(opts.pop("exclude", ()))
        try:
            return SurrogateConfig(**opts), exclude
        except TypeError as e:
            raise ValueError(f"bad surrogate options {sorted(opts)}: "
                             f"{e}") from None

    def _fit_gate(self, ck: str, g: Dict) -> Optional[SurrogateGate]:
        """Fit the evaluation-gating surrogate for one opened group from
        every OTHER cached archive the manifest indexes (minus the
        ``exclude`` keys), plus the group's own archived rows, on the
        service's device.  ``None`` when the harvest is below
        ``SurrogateConfig.min_rows``: the caller then runs the exact path,
        bit-identical to no surrogate."""
        cfg, exclude = self._gate_config(g)
        arc = g["arc"]
        emb = np.asarray(g["embedding"], np.float32).ravel()
        design_dim = design_encoding_dim(
            {k: v[0] for k, v in arc.designs.items()})
        with obs.span("explore.surrogate_fit", key=ck):
            index = self.manifest.export_index(exclude=(ck,) + exclude)
            X, Y = harvest_rows(index, self._load_neighbor, design_dim,
                                emb.size)
            own_X, own_Y = arc.export_rows()
            if len(own_X):
                own = np.concatenate(
                    [own_X, np.tile(emb, (len(own_X), 1))], axis=1)
                X = np.concatenate([X, own]) if len(X) else own
                Y = np.concatenate([Y, own_Y]) if len(Y) else own_Y
            sur = fit_surrogate(X, Y, cfg, device=self.device)
        if sur is None:
            obs.inc("explore.surrogate.cold")
            return None
        return SurrogateGate(model=sur, embedding=emb, cfg=cfg)

    def _stored_gate(self, path: Path, g: Dict) -> Optional[SurrogateGate]:
        """The surrogate a stopped gated run checkpointed, bound to this
        group, when its config is the one asked for (``_refine`` then holds
        the rest of the checkpoint's signature); ``None`` otherwise."""
        if not Path(path).exists():
            return None
        cfg, _ = self._gate_config(g)
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["__meta"]).decode())
                sm = meta.get("surrogate")
                if sm is None or SurrogateConfig(**sm["config"]) != cfg:
                    return None
                sur = Surrogate(
                    params={k[2:]: z[k].copy() for k in z.files
                            if k.startswith("s_")},
                    x_mean=z["sx_mean"].copy(), x_std=z["sx_std"].copy(),
                    y_mean=z["sy_mean"].copy(), y_std=z["sy_std"].copy(),
                    config=cfg, n_rows=int(sm["n_rows"]))
        except (OSError, ValueError, KeyError, TypeError, EOFError,
                zipfile.BadZipFile):
            return None
        return SurrogateGate(model=sur, embedding=np.asarray(
            g["embedding"], np.float32).ravel(), cfg=cfg)

    # ---- cross-problem megabatching ----------------------------------------
    def _fuse_signature(self, g: Dict):
        """What two problem groups must share to run as lanes of one
        fused run: padded dims, the space's bounds, the objective columns
        and the quantized segment schedule (the service's NSGA config and
        tech are common to all).  Spec tensor VALUES differ per lane."""
        spec, space = g["spec"], g["space"]
        sched = quantize.schedule(g["budget"], self.nsga.pop,
                                  self.policy.chunk_generations)
        return ((spec.W, spec.CH, spec.E), g["union"], space.max_shape,
                space.max_logB, space.max_total_pes, space.fixed_packaging,
                space.fixed_family, space.allow_pipeline, sched)

    def _megabatch_pass(self, groups: Dict[str, Dict], gkeys, on_segment,
                        seq, control) -> set:
        """Bucket this batch's cold, megabatch-willing, ungated groups by
        fuse signature and answer every bucket of >= 2 problems with one
        fused refinement.  Returns the keys of the groups handled here
        (warm groups it served included); the caller runs the rest."""
        done: set = set()
        buckets: Dict[tuple, List[Tuple[str, Dict]]] = {}
        for ck, g in groups.items():
            if not all(q.megabatch for q in g["queries"]):
                continue
            if any(q.surrogate is not None for q in g["queries"]):
                continue        # gated groups run the sequential loop
            t0 = time.perf_counter()
            if self._open_group(ck, g):
                g["elapsed"] = time.perf_counter() - t0     # warm: served
                done.add(ck)
                continue
            buckets.setdefault(self._fuse_signature(g), []).append((ck, g))
        cap = max(2, int(self.policy.megabatch_lanes))
        for bucket in buckets.values():
            for lo in range(0, len(bucket), cap):
                part = bucket[lo:lo + cap]
                if len(part) < 2:       # nothing to fuse with: left to the
                    continue            # sequential loop
                self._refine_group_fused(part, gkeys, on_segment, seq,
                                         control)
                done.update(ck for ck, _ in part)
        return done

    def _refine_group_fused(self, bucket: List[Tuple[str, Dict]], gkeys,
                            on_segment, seq, control) -> None:
        """Run one bucket of distinct-problem groups as the lanes of one
        fused run, then book each group as the sequential path would."""
        t0 = time.perf_counter()
        with obs.span("explore.megabatch", lanes=len(bucket),
                      keys=",".join(ck for ck, _ in bucket)) as sp:
            lanes = [dict(g=g, key=gkeys[ck],
                          seeds=self._group_seeds(ck, g, gkeys[ck]),
                          cb=self._segment_cb(on_segment, ck, "refine",
                                              seq))
                     for ck, g in bucket]
            results = self._refine_fused(lanes, control=control)
            for (ck, g), r in zip(bucket, results):
                self._book_refinement(ck, g, None, *r)
            sp.set(n_run=sum(r[0] for r in results))
        dt = time.perf_counter() - t0
        for _, g in bucket:     # every lane waited on the same launches
            g["elapsed"] = dt

    def _refine_fused(self, lanes: List[Dict], control=None) -> List[Tuple]:
        """The megabatched ``_refine``: every lane (one problem group)
        shares one quantized schedule and one ``make_nsga_fused`` runner;
        per-lane archives, seeding, plateau streaks, traces and banking
        follow the sequential semantics segment by segment.  The lane
        count is pow2-padded (``quantize.bucket_lanes``): padding slots
        replay the first live lane and their outputs are discarded, and a
        lane that plateaus stops booking while the width stays.  Returns
        ``(n_run, trace, plateaued, banked, interrupted)`` per lane."""
        policy = self.policy
        g0 = lanes[0]["g"]
        union = g0["union"]
        sched = quantize.schedule(g0["budget"], self.nsga.pop,
                                  policy.chunk_generations)
        pop, chunk, n_seg = sched.pop, sched.chunk, sched.n_seg
        cfg = dataclasses.replace(self.nsga, pop=pop, generations=chunk)
        lanes_pad = quantize.bucket_lanes(len(lanes))
        run = make_nsga_fused(g0["spec"], g0["space"], union, cfg,
                              tech=self.tech, lanes=lanes_pad,
                              device=self.device)
        hv_pairs = [(METRIC_KEYS.index(union[i]),
                     METRIC_KEYS.index(union[j]))
                    for i, j in objective_pairs(len(union))]
        for ln in lanes:
            ln.update(k_run=fold_in(ln["key"], 1), trace=None,
                      plateaued=False, interrupted=False, spent_g=0,
                      live=True, st=ln["g"]["plateau"],
                      filler=random_design(fold_in(ln["key"], 0),
                                           ln["g"]["space"], n=pop,
                                           device=self.device))
        for s in range(n_seg):
            live = [ln for ln in lanes if ln["live"]]
            if not live:
                break
            if control is not None and control.stopped:
                for ln in live:
                    ln["interrupted"] = True
                break
            t_seg = time.perf_counter()
            compiled = not run.compile_state["executed"]
            slots = live + [live[0]] * (lanes_pad - len(live))
            pops = [_seed_population(ln["g"]["arc"], pop, ln["filler"],
                                     ln["seeds"] if s == 0 else None)
                    for ln in slots]
            pop_s, _raw, _sel, ev_d, ev_r, ev_f, tr = run(
                [fold_in(ln["k_run"], s) for ln in slots],
                {k: torch.stack([p[k] for p in pops]) for k in pops[0]},
                [ln["g"]["spec"].arrays for ln in slots])
            # per-lane booking, as one sequential segment; padding slots
            # (j >= len(live)) book nothing
            staged = []
            for j, ln in enumerate(live):
                arc = ln["g"]["arc"]
                arc.insert({k: v[j].reshape((-1,) + v.shape[3:])
                            for k, v in ev_d.items()},
                           ev_r[j].reshape(-1, ev_r.shape[-1]),
                           mask=ev_f[j].reshape(-1), count_evals=False)
                arc.n_evals += pop * chunk
                ln["spent_g"] += chunk
                ln["filler"] = {k: v[j] for k, v in pop_s.items()}
                seg_trace = ConvergenceTrace.from_scan(
                    union, {k: v[j] for k, v in tr.items()}, pop)
                hv_now = np.asarray([arc.projected_hypervolume(p)
                                     for p in hv_pairs])
                seg_trace.archive_hv = hv_now[None, :]
                ln["trace"] = (seg_trace if ln["trace"] is None
                               else ln["trace"].extend(seg_trace))
                staged.append((ln, seg_trace, hv_now))
            dt = time.perf_counter() - t_seg    # shared by every lane
            obs.inc("explore.segments")
            obs.observe("explore.segment_compile_s" if compiled
                        else "explore.segment_s", dt)
            for ln, seg_trace, hv_now in staged:
                if ln["cb"] is not None:
                    ln["cb"](s, seg_trace, dt, compiled)
                if policy.adaptive and hv_pairs:
                    streak = ln["st"].observe(
                        hv_now, policy.plateau_rel,
                        count=bool(len(ln["g"]["arc"])))
                    if streak >= policy.patience and s + 1 < n_seg:
                        ln["plateaued"] = True
                        ln["live"] = False
                        obs.inc("explore.plateau_stops")
        out = []
        for ln in lanes:
            n_run = ln["spent_g"] * pop
            banked = (max(0, ln["g"]["budget"] - n_run)
                      if ln["plateaued"] else 0)
            out.append((n_run, ln["trace"], ln["plateaued"], banked,
                        ln["interrupted"]))
        return out

    def _record_trust(self, ck: str, g: Dict,
                      trace: Optional[ConvergenceTrace],
                      m: ArchiveManifest) -> None:
        """Book one outcome per seeding neighbor: the run's observed lift,
        keyed by the (src, dst) embedding delta; LRU-touch those neighbors.
        Single-objective runs carry no lift signal and record nothing."""
        if not g["transferred_from"] or trace is None or not trace.pairs:
            return
        lift = _transfer_lift(trace)
        for nk in g["transferred_from"]:
            ent = m.entries.get(nk)
            if ent is None:
                continue
            m.record_transfer(nk, ck, embedding_delta(g["embedding"],
                                                      ent["embedding"]),
                              lift)
            m.touch(nk)

    def _update_manifest(self, ck: str, g: Dict,
                         m: Optional[ArchiveManifest] = None) -> None:
        """Refresh one problem's index entry (embedding, counters,
        migration digest) and persist the manifest under its file lock:
        when a peer committed since this snapshot was read, the snapshot is
        merged into a fresh read of the disk state instead of replacing
        it.  A lock timeout degrades to an unmerged save with a warning."""
        arc, spec = g["arc"], g["spec"]
        m = m if m is not None else self.manifest
        m.update(ck, embedding=g["embedding"],
                 dims=(spec.W, spec.CH, spec.E),
                 n_evals=arc.n_evals, budget_covered=arc.budget_covered,
                 searched=arc.searched,
                 digest=space_digest(g["space"]).to_json_dict())
        path = self.cache_dir / MANIFEST_NAME
        try:
            with file_lock(lock_path(path)):
                if self._manifest_stat() != self._manifest_mtime:
                    disk = ArchiveManifest.load(
                        path, policy=self.manifest_policy)
                    disk.merge(m)
                    disk.enforce(protect=(ck,))
                    m = disk
                    obs.inc("explore.manifest.merges")
                m.reap_evicted(self.cache_dir)
                m.save(path)
        except LockTimeout as e:
            warnings.warn(f"manifest lock busy ({e}); saving unmerged")
            m.save(path)
        self._manifest = m              # what was just saved IS current
        self._manifest_mtime = self._manifest_stat()

    def _load_neighbor(self, nk: str) -> Optional[ParetoArchive]:
        """A neighbor archive for seed migration, through the LRU
        side-cache keyed on the npz mtime; ``None`` for an absent or
        unreadable file."""
        p = self._path(nk)
        try:
            mt = p.stat().st_mtime_ns
        except OSError:
            return None
        hit = self._neighbor_cache.get(nk)
        if hit is not None and hit[0] == mt:
            self._neighbor_cache.move_to_end(nk)
            return hit[1]
        try:
            arc = ParetoArchive.load(p, device=self.device)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            warnings.warn(f"skipping unreadable neighbor archive {p}: {e}")
            return None
        self._neighbor_cache[nk] = (mt, arc)
        self._neighbor_cache.move_to_end(nk)
        while len(self._neighbor_cache) > self._neighbor_cache_cap:
            self._neighbor_cache.popitem(last=False)
        return arc

    def _transfer_plan(self, ck: str, embedding, cap: int
                       ) -> Tuple[ArchiveManifest,
                                  List[Tuple[str, float]], Dict[str, int]]:
        """The evaluation-free half of transfer seeding: one manifest
        snapshot, the trust-reweighted ``transfer_k`` nearest neighbors of
        ``embedding`` (``ck`` excluded), and each neighbor's seed quota out
        of ``cap``.  ``_transfer_seeds`` executes this plan;
        ``Session.plan`` reports it."""
        m = self.manifest
        trust = m.trust_model(dim=int(np.asarray(embedding).size))
        neigh = m.nearest(embedding, k=self.transfer_k, exclude=(ck,),
                          trust=trust)
        cap = max(int(cap), 1)
        if trust is not None and neigh:
            w = [1.0 + max(trust.predict(embedding_delta(
                embedding, m.entries[nk]["embedding"])), 0.0)
                for nk, _ in neigh]
            quotas = {nk: max(1, int(round(cap * wi / sum(w))))
                      for (nk, _), wi in zip(neigh, w)}
        else:
            quota = max(1, cap // max(self.transfer_k, 1))
            quotas = {nk: quota for nk, _ in neigh}
        return m, neigh, quotas

    def _transfer_seeds(self, ck: str, space: DesignSpace, embedding,
                        key: int, arc: Optional[ParetoArchive] = None,
                        cap: Optional[int] = None
                        ) -> Tuple[Optional[Dict], Tuple[str, ...]]:
        """Seed designs (stacked numpy) for a cold or resumed query: the
        migrated, repaired fronts of the best cached neighbors, capped at
        ``cap``, minus seeds the destination front already holds
        (``portable_signature``).  With no usable neighbor a COLD start
        gets one repaired ``balanced_init`` design drawn from ``key``; a
        resumed archive gets nothing."""
        dst = space_digest(space)
        cap = max(self.nsga.pop, 1) if cap is None else max(int(cap), 1)
        n_front = len(arc) if arc is not None else 0
        m, neigh, quotas = self._transfer_plan(ck, embedding, cap)
        taken: set = set()
        if n_front and neigh:
            fr_designs, _ = arc.front()
            for i in range(n_front):
                d = {k2: v[i] for k2, v in fr_designs.items()}
                taken.add(portable_signature(d, dst))
        seeds: List[Dict] = []
        srcs: List[str] = []
        for nk, _dist in neigh:
            ent = m.entries[nk]
            if ent.get("digest") is None:
                continue
            n_arc = self._archives.get(nk)
            if n_arc is None:
                n_arc = self._load_neighbor(nk)
            if n_arc is None:
                continue
            migrated: List[Dict] = []
            designs, objs = n_arc.front()
            for i in range(len(objs)):
                if len(migrated) >= quotas.get(nk, 1):
                    break
                d = {k2: v[i] for k2, v in designs.items()}
                md = migrate(d, ent["digest"], dst)
                sig = portable_signature(md, dst)
                if sig in taken:        # already on the destination front
                    obs.inc("explore.transfer.seeds_deduped")
                    continue            # (or offered by a closer neighbor)
                taken.add(sig)
                migrated.append(md)
            if migrated:                # nk is credited iff its designs
                obs.inc("explore.transfer.seeds_injected", len(migrated))
                seeds.extend(migrated)  # were injected
                srcs.append(nk)
            if len(seeds) >= cap:
                break
        if not seeds:
            if n_front:
                return None, ()
            seeds = [repair(balanced_init(key, space, device=self.device),
                            dst)]
        seeds = seeds[:cap]
        return ({k2: np.stack([s[k2] for s in seeds])
                 for k2 in seeds[0]}, tuple(srcs))

    def _reallocate(self, groups: Dict[str, Dict], key: int, on_segment,
                    seq, control: Optional[RunControl] = None) -> None:
        """Spend the ledger on this batch's under-explored archives —
        groups that ran their whole budget WITHOUT plateauing — lowest
        eval-count first.  Spent credit drains FIFO from the ledger;
        credit no group can use stays banked.  Interrupted groups take no
        top-up, and a stopped control ends the phase."""
        pool = sum(self.ledger.values())
        takers = sorted(
            ((ck, g) for ck, g in groups.items()
             if not g["warm"] and g["n_run"] and not g["plateaued"]
             and not g["interrupted"]),
            key=lambda item: item[1]["arc"].n_evals)
        for i, (ck, g) in enumerate(takers):
            if control is not None and control.stopped:
                break
            if pool < quantize.MIN_POP:     # below the smallest population
                break
            arc = g["arc"]
            t0 = time.perf_counter()
            g["plateau"].reset()            # a top-up is FRESH budget
            # quantize_down: the ledger is never overdrawn by rounding
            with obs.span("explore.reallocate", key=ck, pool=pool) as sp:
                n_run, trace, plateaued, _, interrupted, _ = self._refine(
                    arc, g["spec"], g["space"], g["union"], pool,
                    fold_in(key, i), quantize_down=True,
                    on_segment=self._segment_cb(on_segment, ck, "realloc",
                                                seq),
                    plateau=g["plateau"], control=control)
                sp.set(n_run=n_run)
            obs.inc("explore.evals.realloc", n_run)
            pool -= n_run
            self._drain_ledger(n_run)
            g["elapsed"] += time.perf_counter() - t0
            g["n_run"] += n_run
            g["realloc"] += n_run
            g["plateaued"] = plateaued
            g["interrupted"] = g["interrupted"] or interrupted
            if trace is not None:
                g["trace"] = (g["trace"].extend(trace)
                              if g["trace"] is not None else trace)
            if g["trace"] is not None:
                arc.trace_summary = g["trace"].summary()
            self.save(ck)
            self._update_manifest(ck, g)

    def _drain_ledger(self, spent: int) -> None:
        for ck in list(self.ledger):
            if spent <= 0:
                break
            take = min(self.ledger[ck], spent)
            self.ledger[ck] -= take
            spent -= take
            if self.ledger[ck] <= 0:
                del self.ledger[ck]

    def _project_group(self, ck: str, g: Dict) -> List[ExploreResult]:
        """Project every query's front out of the group archive."""
        designs, metrics = g["arc"].front()
        results = []
        for q in g["queries"]:
            idx = [METRIC_KEYS.index(o) for o in q.objectives]
            cols = metrics[:, idx]
            keep = pareto_front(cols) if len(cols) else []
            results.append(ExploreResult(
                objectives=q.objectives,
                front_objs=cols[keep],
                front_metrics=metrics[keep],
                front_designs=[{k: v[i] for k, v in designs.items()}
                               for i in keep],
                from_cache=g["warm"], n_evals_run=g["n_run"],
                elapsed_s=g["elapsed"], cache_key=ck,
                trace=g["trace"], plateaued=g["plateaued"],
                n_evals_banked=g["banked"], n_evals_realloc=g["realloc"],
                transferred_from=g["transferred_from"],
                n_transfer_seeds=g["n_seeds"],
                interrupted=g["interrupted"], surrogate_used=g["sur_used"],
                surrogate_hits=g["sur_hits"],
                surrogate_fallbacks=g["sur_fallbacks"]))
        return results

    # ---- checkpoints -------------------------------------------------------
    def _mesh_for(self, pop: int):
        """The service mesh, when a ``pop``-wide population can split over
        it (every island at least 2 designs); ``None`` (the plain loop)
        otherwise — small quantized budgets must not fail, they just do
        not scale."""
        if self.mesh is None:
            return None
        n = int(self.mesh.shape.get(ISLAND_AXIS, 1))
        return self.mesh if (pop % n == 0 and pop // n >= 2) else None

    def _ckpt_signature(self, objectives: Tuple[str, ...], budget: int,
                        pop: int, generations: int, chunk: int, key: int,
                        seeds: Optional[Dict],
                        gate_digest: Optional[str] = None) -> str:
        """Identity of one deterministic refinement: everything that fixes
        the port's segment-by-segment numeric stream (salted with
        ``CACHE_SALT``), the gating surrogate's digest included — a gated
        run never splices into an ungated one or one under another
        surrogate — and the device type: CUDA and CPU generators draw
        different streams from one seed, so a run resumed on another device
        would splice two streams into a front neither device gives
        uninterrupted (under a mesh, the device types its islands evolve
        on); and the island count, which changes the streams and the
        migrations.  A checkpoint of another signature answers a different
        run and is ignored."""
        h = hashlib.sha256()
        mesh = self._mesh_for(pop)
        kind = self.device.type
        if mesh is not None:
            kinds = tuple(d.type for d, isl in mesh.blocks() for _ in isl)
            kind = kinds[0] if len(set(kinds)) == 1 else kinds
        h.update(repr((CACHE_SALT, tuple(objectives), int(budget), int(pop),
                       int(generations), int(chunk), int(self.capacity),
                       repr(self.nsga), island_count(mesh),
                       tech_key(self.tech or DEFAULT_TECH),
                       int(key), gate_digest, kind)).encode())
        if seeds is not None:
            for k in sorted(seeds):
                h.update(k.encode())
                h.update(np.asarray(seeds[k]).tobytes())
        return h.hexdigest()[:16]

    @staticmethod
    def _save_ckpt(path, sig: str, s_next: int, spent_g: int, spent_e: int,
                   fell_back: bool, arc: ParetoArchive, filler: Dict,
                   trace: ConvergenceTrace, st: PlateauState,
                   sur: Optional[Surrogate] = None) -> None:
        """One atomic npz holding a consistent mid-run snapshot: the
        archive after segment ``s_next - 1``'s insert, the evolving
        population that segment produced, the accumulated trace, the
        plateau detector's memory, the exact evaluations spent (``spent_e``;
        fewer than ``spent_g`` x pop under gating), whether the gate was
        abandoned, and the gating surrogate itself (a resume replays it).
        A write failure is a warning."""
        try:
            meta = dict(
                sig=sig, s_next=int(s_next), spent_g=int(spent_g),
                spent_e=int(spent_e), fell_back=bool(fell_back),
                streak=int(st.streak),
                last_hv=([float(v) for v in st.last_hv]
                         if st.last_hv is not None else None),
                arc=dict(n_evals=arc.n_evals,
                         budget_covered=arc.budget_covered,
                         searched=list(arc.searched)),
                trace=dict(objectives=list(trace.objectives),
                           pairs=[list(p) for p in trace.pairs],
                           has_archive_hv=trace.archive_hv is not None,
                           has_hv_gen=trace.hv_gen is not None),
                surrogate=(None if sur is None else dict(
                    config=dataclasses.asdict(sur.config),
                    n_rows=sur.n_rows)))
            arrays = dict(
                objs=arc.objs.cpu().numpy(), valid=arc.valid.cpu().numpy(),
                t_front_size=np.asarray(trace.front_size),
                t_hypervolume=np.asarray(trace.hypervolume),
                t_best=np.asarray(trace.best),
                t_feasible_frac=np.asarray(trace.feasible_frac),
                t_n_evals=np.asarray(trace.n_evals))
            if trace.archive_hv is not None:
                arrays["t_archive_hv"] = np.asarray(trace.archive_hv)
            if trace.hv_gen is not None:
                arrays["t_hv_gen"] = np.asarray(trace.hv_gen)
            arrays.update({f"d_{k}": v.cpu().numpy()
                           for k, v in arc.designs.items()})
            arrays.update({f"f_{k}": v.cpu().numpy()
                           for k, v in filler.items()})
            if sur is not None:
                arrays.update({f"s_{k}": v for k, v in sur.params.items()})
                arrays.update(sx_mean=sur.x_mean, sx_std=sur.x_std,
                              sy_mean=sur.y_mean, sy_std=sur.y_std)
            with obs.span("explore.checkpoint", segment=int(s_next) - 1):
                atomic_savez(path, __meta=np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        except OSError as e:
            warnings.warn(f"resume checkpoint write failed ({path}): {e}")

    @staticmethod
    def _load_ckpt(path, sig: str, arc: ParetoArchive, st: PlateauState
                   ) -> Optional[Tuple[int, int, int, bool, Dict,
                                       ConvergenceTrace]]:
        """Restore a mid-run snapshot into ``arc``/``st`` if ``path`` holds
        a checkpoint of THIS run (signature match, compatible shapes).
        Returns ``(s_next, spent_g, spent_e, fell_back, filler, trace)``, or
        ``None`` (no, foreign or damaged checkpoint: start from scratch)."""
        path = Path(path)
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["__meta"]).decode())
                if meta["sig"] != sig:
                    return None
                objs, valid = z["objs"], z["valid"]
                designs = {k[2:]: z[k].copy() for k in z.files
                           if k.startswith("d_")}
                if (tuple(objs.shape) != tuple(arc.objs.shape)
                        or set(designs) != set(arc.designs)):
                    return None
                filler = {k[2:]: z[k].copy() for k in z.files
                          if k.startswith("f_")}
                tm = meta["trace"]
                trace = ConvergenceTrace(
                    objectives=tuple(tm["objectives"]),
                    pairs=tuple(tuple(p) for p in tm["pairs"]),
                    front_size=z["t_front_size"].copy(),
                    hypervolume=z["t_hypervolume"].copy(),
                    best=z["t_best"].copy(),
                    feasible_frac=z["t_feasible_frac"].copy(),
                    n_evals=z["t_n_evals"].copy(),
                    archive_hv=(z["t_archive_hv"].copy()
                                if tm["has_archive_hv"] else None),
                    hv_gen=(z["t_hv_gen"].copy()
                            if tm["has_hv_gen"] else None))
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            warnings.warn(f"discarding unreadable resume checkpoint "
                          f"{path}: {e}")
            return None
        dev = arc.device
        arc.objs = torch.as_tensor(objs, device=dev)
        arc.valid = torch.as_tensor(valid, device=dev)
        arc.designs = {k: torch.as_tensor(v, device=dev)
                       for k, v in designs.items()}
        arc.n_evals = int(meta["arc"]["n_evals"])
        arc.budget_covered = int(meta["arc"]["budget_covered"])
        arc.searched = tuple(meta["arc"]["searched"])
        st.streak = int(meta["streak"])
        st.last_hv = (np.asarray(meta["last_hv"], np.float64)
                      if meta["last_hv"] is not None else None)
        filler = {k: torch.as_tensor(v, device=dev)
                  for k, v in filler.items()}
        obs.inc("explore.resume.restored")
        return (int(meta["s_next"]), int(meta["spent_g"]),
                int(meta["spent_e"]), bool(meta["fell_back"]), filler, trace)

    # ---- one refinement ----------------------------------------------------
    def _refine(self, arc: ParetoArchive, spec: SystemSpec,
                space: DesignSpace, objectives: Tuple[str, ...],
                budget: int, key: int, quantize_down: bool = False,
                seeds: Optional[Dict] = None, on_segment=None,
                plateau: Optional[PlateauState] = None,
                control: Optional[RunControl] = None, checkpoint=None,
                gate: Optional[SurrogateGate] = None
                ) -> Tuple[int, Optional[ConvergenceTrace], bool, int, bool,
                           Dict[str, int]]:
        """Spend up to ~``budget`` evaluations improving the archive:
        warm-start the population from the cached front (and ``seeds``, a
        stacked numpy design dict, in segment 0), evolve in segments,
        insert every feasible evaluation, stop early on plateau.

        The population (for sub-``nsga.pop`` budgets), the generation count
        and the per-segment chunk are quantized to powers of two, as in the
        reference; ``quantize_down`` floors instead (ledger credit must not
        be overdrawn).  ``checkpoint`` (a path) turns on per-segment
        checkpointing and resume-on-entry; ``control`` is polled at each
        segment boundary.  ``gate`` (a ``SurrogateGate``) runs each segment
        through ``make_nsga_gated``: only ``cfg.n_exact(pop)`` of every
        generation's candidates are evaluated (the rest count as hits), and
        a segment whose mean disagreement exceeds ``fallback_tau`` ends the
        gating for the rest of the run.  Returns ``(n_run, trace,
        plateaued, banked, interrupted, sur_stats)``: ``n_run`` counts THIS
        attempt's exact evaluations (a resumed run reports its residual
        spend); ``sur_stats`` holds ``used`` / ``hits`` / ``fallbacks``."""
        policy = self.policy
        sched = quantize.schedule(budget, self.nsga.pop,
                                  policy.chunk_generations, quantize_down)
        pop, generations = sched.pop, sched.generations
        chunk, n_seg = sched.chunk, sched.n_seg
        cfg = dataclasses.replace(self.nsga, pop=pop, generations=chunk)
        mesh = self._mesh_for(pop)
        run = make_nsga(spec, space, objectives, cfg, tech=self.tech,
                        device=self.device, mesh=mesh)
        sur_stats = dict(used=False, hits=0, fallbacks=0)
        run_g, sur, n_exact = None, None, pop
        if gate is not None and gate.cfg.n_exact(pop) < pop and mesh is None:
            # gating is single-device, as in the reference: a meshed
            # service runs exact rather than fail the query
            n_exact = gate.cfg.n_exact(pop)
            run_g = make_nsga_gated(spec, space, objectives, cfg,
                                    tech=self.tech, n_exact=n_exact,
                                    beta=gate.cfg.beta, tau=gate.cfg.tau,
                                    device=self.device)
            sur = gate.model.scan_arrays(gate.embedding, self.device)
        # archive-projected hypervolume pairs, in METRIC_KEYS column space
        hv_pairs = [(METRIC_KEYS.index(objectives[i]),
                     METRIC_KEYS.index(objectives[j]))
                    for i, j in objective_pairs(len(objectives))]
        k_init, k_run = fold_in(key, 0), fold_in(key, 1)
        filler = random_design(k_init, space, n=pop, device=self.device)
        st = plateau if plateau is not None else PlateauState()
        trace, plateaued, interrupted, spent_g = None, False, False, 0
        spent_e = 0                     # exact evaluations this attempt
        s0, spent0, spent0_e, sig = 0, 0, 0, None   # a stopped attempt's
        if checkpoint is not None:
            sig = self._ckpt_signature(
                objectives, budget, pop, generations, chunk, key, seeds,
                gate_digest=(gate.model.digest()
                             if run_g is not None else None))
            rest = self._load_ckpt(checkpoint, sig, arc, st)
            if rest is not None:
                s0, spent0, spent0_e, fell_back0, filler, trace = rest
                if fell_back0 and run_g is not None:
                    run_g = None        # the stopped attempt had already
                    sur_stats["used"] = True    # abandoned the surrogate
                    sur_stats["fallbacks"] += 1
        for s in range(s0, n_seg):
            if control is not None and control.stopped:
                interrupted = True      # the checkpoint stays for a resume
                break
            t_seg = time.perf_counter()
            # the first run of this runner variant in the process loads the
            # kernels and warms the caches: its segment is timed apart
            compiled = not (run_g if run_g is not None
                            else run).compile_state["executed"]
            pop0 = _seed_population(arc, pop, filler,
                                    seeds if s == 0 else None)
            if run_g is not None:
                out = run_g(fold_in(k_run, s), pop0, sur)
                per_gen = n_exact       # only the gate's exact slots cost
            else:
                out = run(fold_in(k_run, s), pop0)
                per_gen = pop
            pop_s, _raw, _sel, ev_designs, ev_raw, ev_feas, tr = out
            # archive EVERY evaluation of the segment, masked to feasible
            # designs so no served front carries a constraint violation
            arc.insert({k: v.reshape((-1,) + v.shape[2:])
                        for k, v in ev_designs.items()},
                       ev_raw.reshape(-1, ev_raw.shape[-1]),
                       mask=ev_feas.reshape(-1), count_evals=False)
            arc.n_evals += per_gen * chunk
            spent_g += chunk
            spent_e += per_gen * chunk
            filler = pop_s
            seg_trace = ConvergenceTrace.from_scan(objectives, tr, per_gen)
            if run_g is not None:
                skipped = (pop - n_exact) * chunk
                sur_stats["used"] = True
                sur_stats["hits"] += skipped
                obs.inc("explore.surrogate.hits", skipped)
                obs.inc("explore.surrogate.forced_exact",
                        int(tr["forced_exact"].sum()))
                dis = float(np.mean(tr["disagreement"].cpu().numpy()))
                if dis > gate.cfg.fallback_tau:
                    # the ensemble is out of its depth here: exact for the
                    # rest of the run
                    run_g = None
                    sur_stats["fallbacks"] += 1
                    obs.inc("explore.surrogate.fallbacks")
            hv_now = np.asarray([arc.projected_hypervolume(p)
                                 for p in hv_pairs])
            seg_trace.archive_hv = hv_now[None, :]
            trace = seg_trace if trace is None else trace.extend(seg_trace)
            # the hypervolume above read the archive back to the host, so
            # the segment's launches have drained: dt is its wall-clock
            dt = time.perf_counter() - t_seg
            obs.inc("explore.segments")
            obs.observe("explore.segment_compile_s" if compiled
                        else "explore.segment_s", dt)
            if on_segment is not None:
                on_segment(s, seg_trace, dt, compiled)
            # ---- plateau check on the archive-projected hypervolume ----
            if policy.adaptive and hv_pairs:
                streak = st.observe(hv_now, policy.plateau_rel,
                                    count=bool(len(arc)))
                if streak >= policy.patience and s + 1 < n_seg:
                    plateaued = True
                    obs.inc("explore.plateau_stops")
                    break
            if checkpoint is not None:  # after the plateau observation, so
                #                         a resume judges the seam alike
                self._save_ckpt(checkpoint, sig, s + 1, spent0 + spent_g,
                                spent0_e + spent_e,
                                gate is not None and run_g is None,
                                arc, filler, trace, st,
                                sur=gate.model if gate is not None else None)
        n_run = spent_e
        # only budget the caller offered and ALL attempts left unspent is
        # credit (never the pow2 headroom above the requested budget); a
        # gated run's savings are surrogate hits, not ledger credit
        banked = max(0, budget - (spent0_e + spent_e)) if plateaued else 0
        if checkpoint is not None and not interrupted:
            Path(checkpoint).unlink(missing_ok=True)
        return n_run, trace, plateaued, banked, interrupted, sur_stats


# ---------------------------------------------------------------------------
# module-level convenience: a default singleton service
# ---------------------------------------------------------------------------
_DEFAULT: Optional[ExplorationService] = None
_DEFAULT_LOCK = threading.Lock()


def default_service(**kwargs) -> ExplorationService:
    """The process-wide service, built from ``kwargs`` (``device=`` among
    them: the card unless ``device="cpu"``) at the first call; a later
    call with kwargs raises."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ExplorationService(**kwargs)
        elif kwargs:
            raise RuntimeError(
                "the default exploration service is already initialized; "
                "construct ExplorationService(...) directly for a custom "
                "configuration")
        return _DEFAULT


def explore(graph: WorkloadGraph,
            objectives: Sequence[str] = DEFAULT_OBJECTIVES,
            budget: int = 2048, ch_max: int = 4,
            space_kwargs: Optional[Dict] = None,
            transfer: bool = False,
            service: Optional[ExplorationService] = None,
            key=None, device="cuda") -> ExploreResult:
    """One-call front query against ``service``, else the process-wide
    default service (built on ``device`` at the first call).

    DEPRECATED — delegates to the ``ExplorationService.explore`` shim
    (one ``DeprecationWarning``); use ``repro_torch.api.submit``
    instead."""
    svc = service or _DEFAULT or default_service(device=device)
    return svc.explore(graph, objectives, budget, ch_max, space_kwargs,
                       transfer=transfer, key=key)


def _seed_population(arc: ParetoArchive, pop: int, filler: Dict,
                     extra: Optional[Dict] = None) -> Dict:
    """Population for the next segment: the archive front head (the
    all-time best designs), then any transfer ``extra`` seeds (numpy,
    capped by the caller), then the ``filler`` tail (fresh random samples
    for segment 0, then the carried evolving population).  Seeds reserve
    their slots first, so a large front head cannot crowd them out."""
    n_ext = 0
    if extra is not None:
        n_ext = min(int(next(iter(extra.values())).shape[0]), pop)
    n_warm = min(len(arc), pop - n_ext)
    if n_warm + n_ext == 0:
        return filler
    sel = torch.nonzero(arc.valid).flatten()[:n_warm]

    def leaf(k, v):
        parts = []
        if n_warm:
            parts.append(arc.designs[k][sel])
        if n_ext:
            parts.append(torch.as_tensor(
                np.asarray(extra[k][:n_ext]), device=v.device).to(v.dtype))
        parts.append(v[n_warm + n_ext:])
        return torch.cat(parts)

    return {k: leaf(k, v) for k, v in filler.items()}
