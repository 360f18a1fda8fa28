"""The exploration *service*: the NSGA engine backend behind
``repro_torch.api.Session.submit`` — the path a default query takes in
``repro.explore.service``:

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
  in the per-problem ledger.

Archives live on the service's device and every insert runs there.  The
archive cache key is salted with ``CACHE_SALT``, so fronts of the port and
of the reference never share an archive file.  Cross-workload transfer,
the manifest, surrogate gating, megabatching, budget reallocation,
checkpoint/resume and observability are not ported yet: asking for one
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import warnings
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constants import DEFAULT_TECH, TechConstants, tech_key
from ..core.encoding import DesignSpace, random_design
from ..core.evaluate import SystemSpec
from ..core.optimizer import METRIC_KEYS
from ..core.workload import WorkloadGraph
from ..runtime import fold_in, resolve_device
from . import quantize
from .archive import (ConvergenceTrace, ParetoArchive, objective_pairs,
                      pareto_front, spec_space_key)
from .nsga import NSGAConfig, make_nsga

# the default archive cache is anchored to the repo root (four levels above
# this file: src/repro_torch/explore/service.py), NOT the process CWD
DEFAULT_CACHE_DIR = (Path(__file__).resolve().parents[3]
                     / "artifacts" / "explore_cache")
DEFAULT_OBJECTIVES = ("latency_ns", "cost_usd")
# folded into every archive key: the port's evaluator never serves a front
# the reference's wrote, nor the other way round
CACHE_SALT = "repro_torch"


def not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (see ROADMAP.md Queue 1)")


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


@dataclasses.dataclass(frozen=True)
class BudgetPolicy:
    """How a query's evaluation budget is spent (see the reference's
    ``BudgetPolicy``).  ``chunk_generations`` splits the NSGA run into
    segments of that many generations (quantized to a power of two); with
    ``adaptive`` on, refinement stops once EVERY queried objective pair's
    archive-projected hypervolume improved by less than ``plateau_rel``
    for ``patience`` consecutive segments.  Cross-batch reallocation of
    banked credit and megabatching are not ported: their switches default
    to off here, and turning one on raises ``NotImplementedError``."""
    chunk_generations: int = 8
    plateau_rel: float = 0.005
    patience: int = 2
    adaptive: bool = True
    reallocate: bool = False
    megabatch: bool = False

    def __post_init__(self):
        if self.reallocate:
            raise not_ported("budget reallocation (BudgetPolicy.reallocate)")
        if self.megabatch:
            raise not_ported("megabatching (BudgetPolicy.megabatch)")


@dataclasses.dataclass
class PlateauState:
    """The plateau detector's memory across the scan segments refining
    ONE archive: the previous segment's archive-projected hypervolume
    vector and the current below-threshold streak."""
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


@dataclasses.dataclass
class ExploreQuery:
    """One front request (the service-level form of ``api.Query``).
    ``spec``/``space`` optionally carry a prebuilt problem."""
    graph: WorkloadGraph
    objectives: Tuple[str, ...] = DEFAULT_OBJECTIVES
    budget: int = 2048              # total design evaluations (cold)
    ch_max: int = 4
    space_kwargs: Optional[Dict] = None
    spec: Optional[SystemSpec] = None
    space: Optional[DesignSpace] = None

    def __post_init__(self):
        self.objectives = tuple(self.objectives)
        if not self.objectives:
            raise ValueError("at least one objective required")
        bad = [o for o in self.objectives if o not in METRIC_KEYS]
        if bad:
            raise ValueError(f"unknown objectives {bad}; pick from "
                             f"{METRIC_KEYS}")

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
    segment index, the segment's incremental ``ConvergenceTrace`` slice,
    the phase (``"refine"``), its wall-clock and a stream-monotone ``seq``."""
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


class ExplorationService:
    """Holds per-problem archives (memory + disk, on ``device``) and runs
    the NSGA engine on ``device``.  ``ledger`` maps problem key ->
    evaluations banked by plateau early stops."""

    def __init__(self, cache_dir=None, capacity: int = 256,
                 nsga: NSGAConfig = NSGAConfig(), tech=None,
                 policy: BudgetPolicy = BudgetPolicy(), device="cuda"):
        self.device = resolve_device(device)
        if tech is not None and not isinstance(tech, TechConstants):
            raise not_ported("tech presets / calibrated tech artifacts")
        self.cache_dir = resolve_cache_dir(cache_dir)
        self.capacity = int(capacity)
        self.nsga = nsga
        self.tech = tech
        self.policy = policy
        self.ledger: Dict[str, int] = {}
        self._archives: Dict[str, ParetoArchive] = {}

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
        self._archives[key] = arc
        return arc

    def save(self, key: str):
        """Persist one archive (atomically, see ``atomic_savez``)."""
        arc = self._archives.get(key)
        if arc is not None:
            arc.save(self._path(key))

    @staticmethod
    def warm_verdict(arc: ParetoArchive, objectives: Sequence[str],
                     budget: int) -> bool:
        """True when ``arc`` can answer a query over ``objectives`` at
        ``budget`` straight from cache: the covered budget and every
        queried objective are covered."""
        return (len(arc) > 0
                and max(arc.n_evals, arc.budget_covered) >= budget
                and all(o in arc.searched for o in objectives))

    # ---- the query path ----------------------------------------------------
    def run_queries(self, queries: Sequence[ExploreQuery], key: int = 0,
                    on_segment=None) -> List[ExploreResult]:
        """Answer a batch of queries, merging same-problem queries into one
        NSGA run (union objectives, max budget).  ``key`` is the integer
        seed of the batch; group ``i`` draws from ``fold_in(key, i)``.
        ``on_segment`` (callable taking one ``SegmentEvent``) streams each
        segment's incremental trace slice as it finishes."""
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
        for i, (ck, g) in enumerate(groups.items()):
            self._refine_group(ck, g, fold_in(key, i), on_segment, seq)
        group_results = {ck: self._project_group(ck, g)
                         for ck, g in groups.items()}
        return [group_results[ck][slot] for ck, slot in order]

    def _refine_group(self, ck: str, g: Dict, key: int, on_segment,
                      seq) -> None:
        """Serve the group from cache, or spend (or bank) its budget."""
        t0 = time.perf_counter()
        arc = g["arc"] = self.archive_for(g["spec"], g["space"], key=ck)
        budget = g["budget"] = max(q.budget for q in g["queries"])
        union = tuple(k for k in METRIC_KEYS
                      if any(k in q.objectives for q in g["queries"]))
        g.update(warm=self.warm_verdict(arc, union, budget), n_run=0,
                 trace=None, plateaued=False, banked=0)
        if not g["warm"]:
            cb = None
            if on_segment is not None:
                def cb(s, tr, dt):
                    on_segment(SegmentEvent(ck, s, tr, "refine",
                                            elapsed_s=dt, seq=next(seq)))
            n_run, trace, plateaued, banked = self._refine(
                arc, g["spec"], g["space"], union, budget, key,
                on_segment=cb)
            arc.searched = tuple(k for k in METRIC_KEYS
                                 if k in arc.searched or k in union)
            arc.budget_covered = max(arc.budget_covered, budget)
            if banked:
                self.ledger[ck] = self.ledger.get(ck, 0) + banked
            if trace is not None:
                arc.trace_summary = trace.summary()
            g.update(n_run=n_run, trace=trace, plateaued=plateaued,
                     banked=banked)
            self.save(ck)
        g["elapsed"] = time.perf_counter() - t0

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
                n_evals_banked=g["banked"]))
        return results

    def _refine(self, arc: ParetoArchive, spec: SystemSpec,
                space: DesignSpace, objectives: Tuple[str, ...],
                budget: int, key: int, on_segment=None
                ) -> Tuple[int, Optional[ConvergenceTrace], bool, int]:
        """Spend up to ~``budget`` evaluations improving the archive:
        warm-start the population from the cached front, evolve in
        segments, insert every feasible evaluation, stop early on plateau.

        The population (for sub-``nsga.pop`` budgets), the generation count
        and the per-segment chunk are quantized to powers of two, as in the
        reference.  Returns ``(n_run, trace, plateaued, banked)``."""
        policy = self.policy
        sched = quantize.schedule(budget, self.nsga.pop,
                                  policy.chunk_generations)
        pop, chunk, n_seg = sched.pop, sched.chunk, sched.n_seg
        cfg = dataclasses.replace(self.nsga, pop=pop, generations=chunk)
        run = make_nsga(spec, space, objectives, cfg, tech=self.tech,
                        device=self.device)
        # archive-projected hypervolume pairs, in METRIC_KEYS column space
        hv_pairs = [(METRIC_KEYS.index(objectives[i]),
                     METRIC_KEYS.index(objectives[j]))
                    for i, j in objective_pairs(len(objectives))]
        k_init, k_run = fold_in(key, 0), fold_in(key, 1)
        filler = random_design(k_init, space, n=pop, device=self.device)
        st = PlateauState()
        trace, plateaued, spent_g = None, False, 0
        for s in range(n_seg):
            t_seg = time.perf_counter()
            pop_s, _raw, _sel, ev_designs, ev_raw, ev_feas, tr = run(
                fold_in(k_run, s), _seed_population(arc, pop, filler))
            # archive EVERY evaluation of the segment, masked to feasible
            # designs so no served front carries a constraint violation
            arc.insert({k: v.reshape((-1,) + v.shape[2:])
                        for k, v in ev_designs.items()},
                       ev_raw.reshape(-1, ev_raw.shape[-1]),
                       mask=ev_feas.reshape(-1), count_evals=False)
            arc.n_evals += pop * chunk
            spent_g += chunk
            filler = pop_s
            seg_trace = ConvergenceTrace.from_scan(objectives, tr, pop)
            hv_now = np.asarray([arc.projected_hypervolume(p)
                                 for p in hv_pairs])
            seg_trace.archive_hv = hv_now[None, :]
            trace = seg_trace if trace is None else trace.extend(seg_trace)
            dt = time.perf_counter() - t_seg
            if on_segment is not None:
                on_segment(s, seg_trace, dt)
            # ---- plateau check on the archive-projected hypervolume ----
            if policy.adaptive and hv_pairs:
                streak = st.observe(hv_now, policy.plateau_rel,
                                    count=bool(len(arc)))
                if streak >= policy.patience and s + 1 < n_seg:
                    plateaued = True
                    break
        n_run = spent_g * pop
        banked = max(0, budget - n_run) if plateaued else 0
        return n_run, trace, plateaued, banked


def _seed_population(arc: ParetoArchive, pop: int, filler: Dict) -> Dict:
    """Population for the next segment: the archive front head (the
    all-time best designs), then the ``filler`` tail (fresh random samples
    for segment 0, then the carried evolving population)."""
    n_warm = min(len(arc), pop)
    if n_warm == 0:
        return filler
    sel = torch.nonzero(arc.valid).flatten()[:n_warm]
    return {k: torch.cat([arc.designs[k][sel], v[n_warm:]])
            for k, v in filler.items()}
