"""One front door: the declarative Problem / Query / Plan / Session API,
as ``repro.explore.api`` has it, for the NSGA engine and the scalarized
engines (re-exported at ``repro_torch.api``).

* ``Problem``  — a canonical, hashable statement of *what* to search:
  workload graph + objectives + ``DesignSpace`` bounds + padded spec
  space.  Content-addressed (``Problem.key()``, equal to the reference's
  key for the same problem).
* ``Query``    — a request against a problem: evaluation ``budget`` and
  ``engine`` (``"nsga"``, ``"bo_sa"``, ``"two_stage"``, or ``"auto"``:
  ``bo_sa`` with weights, ``nsga`` without).
* ``Plan``     — what ``Session.plan(query)`` returns before any
  evaluation is spent: the engine, the cache-hit verdict, the quantized
  segment schedule, and the predicted transfer neighbors with their seed
  quotas.
* ``Session``  — owns an ``ExplorationService`` on a device;
  ``submit(query | [queries])`` returns one ``Result`` per query with a
  ``Provenance`` record of the cache / transfer / reallocation accounting.
  NSGA queries go through the service (``transfer``, ``resume``,
  ``control``); scalarized queries run the BO x SA engine
  (``core.optimizer``, with ``seed_designs``) on the service's device and
  never touch the archive cache.  A query's ``tech`` routes it to a
  sibling session under that tech, on the same cache directory.

Distinct cold nsga problems of one padded shape fuse into the lanes of one
run (``BudgetPolicy.megabatch``, on by default; ``Query.megabatch=False``
opts out), and ``engine_opts={"surrogate": ...}`` gates an nsga query's
evaluations on a surrogate fit from the fleet cache.

Observability (``repro_torch.obs``, the port's copy of ``repro.obs``):
``Session(journal=...)`` — or ``$REPRO_JOURNAL_DIR`` — attaches a
crash-safe JSONL journal to every ``plan`` / ``submit`` of the session, one
line per plan, scan segment, result and span close, with the reference's
record types and keys (``python -m repro_torch.obs.report`` renders them).
Spans read the host's clock and never synchronize the card: fronts are
bit-identical with observability on or off.

``Session.submit_async(query)`` returns a ``repro_torch.serve.JobHandle``
while a worker thread of the session's ``Executor`` runs the nsga query on
a ``Session.clone()`` (same configuration, journal and device, a service of
its own): durable job records under the cache directory, admission control
with stale fronts under overload, resume from the last checkpointed segment
after a crash.  Nothing is dropped silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
import uuid
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import obs
from ..core.encoding import DesignSpace
from ..core.evaluate import SystemSpec
from ..core.optimizer import (METRIC_KEYS, OBJ_EDP, SAConfig,
                              _optimize_impl, _two_stage_impl)
from ..core.presets import resolve_tech, tech_label
from ..core.workload import WorkloadGraph, workload_features
from ..runtime import fold_in
from . import quantize
from .archive import ConvergenceTrace, pareto_front, spec_space_key
from .nsga import has_run, island_count
from .service import (DEFAULT_OBJECTIVES, BudgetPolicy, ExplorationService,
                      ExploreQuery, ExploreResult, SegmentEvent)
from .surrogate import SurrogateConfig

ENGINES = ("nsga", "bo_sa", "two_stage", "auto")


class Problem:
    """A canonical, hashable exploration problem: *what* to search.

    ``graph`` + ``objectives`` + the ``DesignSpace`` constraint kwargs
    (``space_kwargs``) + the padded spec space (``ch_max``).  Two Problems
    built from equal workloads under equal bounds are ``==`` and hash equal
    (``spec_space_key`` over the padded arrays and static bounds, plus the
    objective tuple)."""

    __slots__ = ("graph", "objectives", "ch_max", "space_kwargs",
                 "spec", "space", "_key")

    def __init__(self, graph: WorkloadGraph,
                 objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                 ch_max: int = 4,
                 space_kwargs: Optional[Dict] = None, *,
                 spec: Optional[SystemSpec] = None,
                 space: Optional[DesignSpace] = None):
        self.objectives = tuple(objectives)
        if not self.objectives:
            raise ValueError("at least one objective required")
        bad = [o for o in self.objectives if o not in METRIC_KEYS]
        if bad:
            raise ValueError(f"unknown objectives {bad}; pick from "
                             f"{METRIC_KEYS}")
        self.spec = spec if spec is not None \
            else SystemSpec.build(graph, ch_max=ch_max)
        self.graph = self.spec.graph
        self.ch_max = int(self.spec.CH)
        self.space = space if space is not None \
            else DesignSpace(self.spec, **(space_kwargs or {}))
        self.space_kwargs = dict(
            max_shape=tuple(self.space.max_shape),
            max_logB=int(self.space.max_logB),
            max_total_pes=int(self.space.max_total_pes),
            fixed_packaging=int(self.space.fixed_packaging),
            fixed_family=int(self.space.fixed_family),
            allow_pipeline=bool(self.space.allow_pipeline))
        h = hashlib.sha256()
        h.update(spec_space_key(self.spec, self.space).encode())
        h.update(repr(self.objectives).encode())
        self._key = h.hexdigest()[:20]

    @classmethod
    def from_spec(cls, spec: SystemSpec, space: DesignSpace,
                  objectives: Sequence[str] = DEFAULT_OBJECTIVES
                  ) -> "Problem":
        """Adopt a prebuilt (SystemSpec, DesignSpace) pair."""
        return cls(spec.graph, objectives=objectives, spec=spec,
                   space=space)

    def key(self) -> str:
        """Content hash of this problem (tech-independent)."""
        return self._key

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, Problem) and self._key == other._key

    def __repr__(self):
        return (f"Problem({self._key}, W={self.spec.W}, "
                f"objectives={self.objectives})")


@dataclasses.dataclass
class Query:
    """One declarative search request against a ``Problem``.

    ``engine`` is ``"nsga"`` (the multi-objective front explorer),
    ``"bo_sa"`` (the nested BO x SA engine under ``weights``),
    ``"two_stage"`` (the paper's architecture-then-integration flow) or
    ``"auto"`` (``bo_sa`` when ``weights`` are given, else ``nsga``).
    ``budget``, ``policy``, ``transfer`` (seed from the migrated fronts
    of the nearest cached problems), ``megabatch`` and
    ``engine_opts={"surrogate": ...}`` (surrogate-gated evaluation: ``True``
    or a dict of ``SurrogateConfig`` overrides, with ``exclude`` keys held
    out of training) apply to the nsga engine; ``weights``,
    ``seed_designs`` (designs, e.g. migrated ones, that replace the leading
    random restarts), ``archive`` and ``engine_opts`` (``n_init``,
    ``n_iter``, ``sa``, ``bo_fields``, ``sa_fields``, ``init_design`` for
    ``bo_sa``; ``n_candidates``, ``sa`` for ``two_stage``) to the
    scalarized ones.  ``tech`` (a preset name or artifact path, a
    ``TechConstants`` or a calibrated tech; ``None`` = the session's)
    evaluates this query under other constants, in an archive of its
    own."""
    problem: Problem
    budget: int = 2048
    engine: str = "auto"
    transfer: bool = False
    weights: Optional[Tuple[float, ...]] = None
    seed_designs: Optional[Sequence[Dict]] = None
    policy: Optional[BudgetPolicy] = None
    archive: Optional[object] = None
    engine_opts: Optional[Dict] = None
    megabatch: bool = True          # allow this nsga query to fuse with
    #                                 OTHER problems of equal padded shape
    #                                 (see BudgetPolicy.megabatch)
    tech: Optional[object] = None

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; pick from "
                             f"{ENGINES}")
        if self.weights is not None:
            self.weights = tuple(float(w) for w in self.weights)

    def resolved_engine(self) -> str:
        if self.engine != "auto":
            return self.engine
        return "bo_sa" if self.weights is not None else "nsga"


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One planned scan segment: ``pop`` designs evaluated per generation
    for ``generations`` generations (``n_evals`` total)."""
    index: int
    pop: int
    generations: int
    n_evals: int


@dataclasses.dataclass(frozen=True)
class NeighborPlan:
    """One predicted transfer source: the neighbor's archive ``key``, its
    trust-reweighted embedding ``distance``, and its seed ``quota``."""
    key: str
    distance: float
    quota: int


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a query WILL do, before any evaluation is spent.

    ``cache_hit`` is the warm-serve verdict (``segments`` is then empty and
    submitting costs nothing).  ``segments`` is the quantized schedule the
    NSGA engine will run (or a scalarized engine's estimated spend, one
    segment).  ``neighbors`` are the predicted transfer sources with their
    seed quotas (``seed_cap`` bounds the total).  Advisory on a shared
    cache: a peer may warm the archive between ``plan`` and ``submit``.
    ``islands`` is how many islands the NSGA loop will split the
    population into (the service mesh's, or 1).  ``predicted_s`` is
    the wall-clock estimate from this process's segment-time histograms
    (``None`` before any segment has run here; 0.0 on a cache hit).
    ``surrogate`` says the query asked for gating, and
    ``predicted_eval_savings`` counts the evaluations the gate would skip
    if the fleet cache yields a fit."""
    engine: str
    cache_key: str
    cache_hit: bool
    budget: int
    objectives: Tuple[str, ...]
    segments: Tuple[SegmentPlan, ...]
    neighbors: Tuple[NeighborPlan, ...] = ()
    seed_cap: int = 0
    islands: int = 1
    predicted_s: Optional[float] = None
    surrogate: bool = False
    predicted_eval_savings: int = 0

    @property
    def n_evals_planned(self) -> int:
        return sum(s.n_evals for s in self.segments)


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where a ``Result`` came from: the engine, the archive it was served
    from, and the cache / transfer / reallocation accounting; ``tech`` is
    ``"default"`` or ``"<preset>@<digest12>"`` (``presets.tech_label``)."""
    cache_key: str
    engine: str
    from_cache: bool
    n_evals_run: int
    n_evals_banked: int
    n_evals_realloc: int
    transferred_from: Tuple[str, ...]
    n_transfer_seeds: int
    plateaued: bool
    elapsed_s: float
    interrupted: bool = False
    stale: bool = False
    surrogate_used: bool = False
    surrogate_hits: int = 0
    surrogate_fallbacks: int = 0
    tech: str = "default"


@dataclasses.dataclass
class Result:
    """The answer to one ``Query``: the Pareto front over the query's
    objectives, the run's ``ConvergenceTrace`` (``None`` on cache hits),
    the provenance, and the engine-native result as ``raw``
    (``ExploreResult`` for nsga, ``SearchResult`` for the scalarized
    engines, which also fill the ``best_*`` fields: numpy values on the
    host)."""
    objectives: Tuple[str, ...]
    front_objs: np.ndarray
    front_metrics: np.ndarray
    front_designs: List[Dict[str, np.ndarray]]
    trace: Optional[ConvergenceTrace]
    provenance: Provenance
    best_design: Optional[Dict] = None
    best_objective: Optional[float] = None
    best_metrics: Optional[Dict] = None
    raw: object = None


# the engine_opts each scalarized engine takes (its keyword arguments)
SCALARIZED_OPTS = {
    "bo_sa": ("n_init", "n_iter", "sa", "bo_fields", "sa_fields",
              "init_design"),
    "two_stage": ("n_candidates", "sa"),
}


def _check_nsga(q: Query) -> None:
    """Raise (``ValueError``, as the reference) for an option the nsga
    engine does not take: its one ``engine_opts`` key is ``surrogate``
    (``True`` or a dict of ``SurrogateConfig`` overrides)."""
    opts = dict(q.engine_opts or {})
    opts.pop("surrogate", None)
    if q.weights is not None or q.seed_designs or q.archive is not None \
            or opts:
        raise ValueError(
            "weights / seed_designs / archive / engine_opts apply to the "
            "scalarized engines; the nsga engine takes budget / transfer / "
            "policy / engine_opts={'surrogate': ...}")


def _validate_scalarized(q: Query, engine: str) -> None:
    """Scalarized engines reject the nsga-only options as loudly as
    ``_check_nsga`` rejects the scalarized-only ones: a transfer or policy
    request is never dropped silently (``budget`` stays nsga-only: the
    scalarized spend derives from ``engine_opts``)."""
    if q.transfer:
        raise ValueError(
            "transfer=True applies to the nsga engine only; seed "
            "scalarized engines explicitly via seed_designs=")
    if q.policy is not None:
        raise ValueError(
            "BudgetPolicy applies to the nsga engine only; size "
            "scalarized engines via engine_opts (n_init/n_iter/sa)")
    bad = sorted(set(q.engine_opts or {}) - set(SCALARIZED_OPTS[engine]))
    if bad:
        raise ValueError(f"engine_opts {bad} do not apply to the {engine!r} "
                         f"engine; it takes {SCALARIZED_OPTS[engine]}")


class Session:
    """The front door: plan and submit declarative queries.

    Wraps an ``ExplorationService`` (constructed from the given kwargs —
    ``cache_dir``, ``capacity``, ``nsga``, ``tech``, ``policy``,
    ``transfer_k``, ``manifest_policy``, ``mesh`` — when not supplied)
    that runs on ``device`` (default ``"cuda"``; without a card it raises
    unless ``device="cpu"`` is passed).  ``mesh=make_island_mesh(n)``
    (``launch.mesh``) runs every NSGA refinement as n islands.  ``tech``
    may be a preset name, an artifact path, a ``TechConstants`` or a
    calibrated tech.

    ``journal`` attaches a ``repro_torch.obs`` run journal to every
    ``plan`` / ``submit`` of this session: a ``Journal``, a path (opened
    append-only on first write), ``None`` (the default — the process
    journal under ``$REPRO_JOURNAL_DIR`` when that is set, else none), or
    ``False`` to opt out even when the variable is set."""

    def __init__(self, service: Optional[ExplorationService] = None,
                 journal=None, device="cuda", **service_kwargs):
        if service is None:
            tech = service_kwargs.get("tech")
            if tech is not None:
                service_kwargs["tech"] = resolve_tech(tech)[1]
            service = ExplorationService(device=device, **service_kwargs)
            self.tech_label = tech_label(tech)
        else:
            self.tech_label = tech_label(service.tech)
        self.service = service
        self._tech_sessions: Dict[str, "Session"] = {}
        self._journal = obs.resolve_journal(journal)
        self._executor = None           # the serve.Executor behind
        #                                 submit_async, built on first use
        # one id per session and a counter per submission: each submit
        # journals under its own run id, so overlapping submissions sharing
        # one fleet journal replay apart
        self._sid = uuid.uuid4().hex[:8]
        self._run_seq = itertools.count()

    @property
    def tech(self):
        return self.service.tech

    def _service_config(self) -> Dict:
        """What a sibling session needs to share this one's cache
        directory, engines and policies."""
        s = self.service
        return dict(cache_dir=s.cache_dir, capacity=s.capacity, nsga=s.nsga,
                    tech=s.tech, policy=s.policy, transfer_k=s.transfer_k,
                    manifest_policy=s.manifest_policy, device=s.device,
                    mesh=s.mesh)

    def clone(self) -> "Session":
        """A sibling session: the same configuration, cache directory,
        journal and device, and a service of its own.  Services are
        single-threaded: the async executor gives each worker thread a
        clone, and the shared cache directory (file locks, reload-merge
        writes) is the only state they share, as between processes."""
        twin = Session(journal=self._journal, **self._service_config())
        twin.tech_label = self.tech_label
        return twin

    def _cache_key(self, p: Problem) -> str:
        """The archive identity of ``p`` under this session's tech."""
        return self.service.problem_key(p.spec, p.space)

    def _session_for(self, tech) -> "Session":
        """The session answering queries under ``tech``: this one when the
        labels match, else a cached sibling on the same cache directory —
        distinct tech digests key distinct archives."""
        if tech is None:
            return self
        label = tech_label(tech)
        if label == self.tech_label:
            return self
        if label not in self._tech_sessions:
            cfg = self._service_config()
            cfg["tech"] = tech
            self._tech_sessions[label] = Session(journal=self._journal,
                                                 **cfg)
        return self._tech_sessions[label]

    # ---- planning ----------------------------------------------------------
    def plan(self, query: Query) -> Plan:
        """What ``submit`` would do for one query, spending no evaluations:
        resolved engine, archive cache key and warm-serve verdict, the
        quantized segment schedule, the predicted wall-clock and — for
        transfer queries — the predicted neighbors with their seed quotas.
        With a journal attached, one ``plan`` record per call lands in it
        (the plan half of the report's plan-vs-actual table)."""
        with obs.sink_attached(self._journal), \
                obs.span("session.plan", engine=query.resolved_engine()):
            pl = self._plan_impl(query)
            if obs.active():
                obs.emit(dict(
                    type="plan", key=pl.cache_key, engine=pl.engine,
                    budget=pl.budget, cache_hit=pl.cache_hit,
                    objectives=list(pl.objectives),
                    segments=[dict(segment=s.index, pop=s.pop,
                                   generations=s.generations,
                                   n_evals=s.n_evals)
                              for s in pl.segments],
                    neighbors=[dict(key=n.key, distance=n.distance,
                                    quota=n.quota) for n in pl.neighbors],
                    seed_cap=pl.seed_cap, islands=pl.islands,
                    predicted_s=pl.predicted_s))
        return pl

    def _plan_impl(self, query: Query) -> Plan:
        sub = self._session_for(query.tech)
        if sub is not self:
            return sub._plan_impl(query)
        engine = query.resolved_engine()
        p = query.problem
        ck = self._cache_key(p)
        if engine in ("bo_sa", "two_stage"):
            _validate_scalarized(query, engine)
            n = _scalarized_evals(query)
            return Plan(engine=engine, cache_key=ck, cache_hit=False,
                        budget=n, objectives=p.objectives,
                        segments=(SegmentPlan(0, 1, 1, n),))
        _check_nsga(query)
        svc = self.service
        arc = svc.archive_for(p.spec, p.space, key=ck)
        budget = int(query.budget)
        if svc.warm_verdict(arc, p.objectives, budget):
            return Plan(engine=engine, cache_key=ck, cache_hit=True,
                        budget=budget, objectives=p.objectives,
                        segments=(), predicted_s=0.0)
        policy = query.policy or svc.policy
        sched = quantize.schedule(budget, svc.nsga.pop,
                                  policy.chunk_generations)
        pop, chunk = sched.pop, sched.chunk
        segments = tuple(SegmentPlan(i, pop, chunk, pop * chunk)
                         for i in range(sched.n_seg))
        mesh = svc._mesh_for(pop)
        predicted = self._predict_s(p, sched, mesh)
        neighbors, cap = (), 0
        if query.transfer:
            cap = pop if len(arc) == 0 else max(pop // 2, 1)
            m, neigh, quotas = svc._transfer_plan(
                ck, workload_features(p.spec.graph), cap)
            neighbors = tuple(
                NeighborPlan(nk, float(dist), int(quotas.get(nk, 1)))
                for nk, dist in neigh
                if m.entries[nk].get("digest") is not None)
        sur_req = dict(query.engine_opts or {}).get("surrogate", None)
        savings = 0
        if sur_req is not None:
            s_opts = {} if sur_req is True else dict(sur_req)
            s_opts.pop("exclude", None)
            scfg = SurrogateConfig(**s_opts)
            savings = (pop - scfg.n_exact(pop)) * chunk * sched.n_seg
        return Plan(engine=engine, cache_key=ck, cache_hit=False,
                    budget=budget, objectives=p.objectives,
                    segments=segments, neighbors=neighbors, seed_cap=cap,
                    islands=island_count(mesh), predicted_s=predicted,
                    surrogate=sur_req is not None,
                    predicted_eval_savings=savings)

    def _predict_s(self, p: Problem, sched: "quantize.Schedule",
                   mesh=None) -> Optional[float]:
        """Wall-clock estimate for one NSGA submission from this process's
        segment-time histograms, as the reference's: the first segment is
        costed at the first-run median when no runner of this variant has
        run in-process yet.  ``None`` while both histograms are empty;
        with only first-run segments seen, their median stands in for the
        steady-state one (a conservative over-estimate)."""
        seg_h = obs.REGISTRY.peek("explore.segment_s")
        comp_h = obs.REGISTRY.peek("explore.segment_compile_s")
        seg_p50 = seg_h.quantile(0.5) if seg_h is not None else None
        comp_p50 = comp_h.quantile(0.5) if comp_h is not None else None
        if seg_p50 is None and comp_p50 is None:
            return None
        if seg_p50 is None:
            seg_p50 = comp_p50
        svc = self.service
        cfg = dataclasses.replace(svc.nsga, pop=sched.pop,
                                  generations=sched.chunk)
        first = seg_p50
        if comp_p50 is not None and not has_run(
                p.spec, p.space, p.objectives, cfg, svc.tech, svc.device,
                mesh):
            first = comp_p50
        return first + (sched.n_seg - 1) * seg_p50

    def submit_async(self, query: Query, key=None,
                     deadline_s: Optional[float] = None):
        """Submit one nsga query asynchronously: returns a
        ``repro_torch.serve.JobHandle`` at once (poll / ``result(timeout)``
        / ``cancel()`` / streamed ``SegmentEvent``s) while a worker thread
        runs the search on this session's device.  ``key`` is the integer
        seed (default 0).  The job's front is ``submit(query, key=key)``'s,
        bit for bit, when the worker's clone has banked nothing: its first
        job, or any job under ``BudgetPolicy(reallocate=False)``.  Under
        the default policy a clone keeps its ledger of banked evaluations
        between jobs, so a job may be topped up with credit an earlier job
        of the same worker banked, and its spend and front then depend on
        the schedule.  Jobs are recorded durably under the cache directory
        and keyed on ``Problem.key()``: a crashed process's jobs are
        recovered (``Executor.resume_pending``) and resume from their last
        completed segment.  Under overload (queue full), a query whose
        archive holds a front is answered at once with that possibly-stale
        front (``provenance.stale=True``) and the refinement stays banked
        in the job store; ``deadline_s`` bounds how long admission may wait
        before it degrades."""
        return self.executor().submit(query, key=key, deadline_s=deadline_s)

    def executor(self, **kwargs):
        """The session's ``repro_torch.serve.Executor`` (built on the first
        ``submit_async``; kwargs only on first construction — build an
        ``Executor`` directly for another configuration)."""
        if self._executor is None:
            from ..serve import Executor
            self._executor = Executor(self, **kwargs)
        elif kwargs:
            raise RuntimeError(
                "this session's executor is already initialized; "
                "construct repro_torch.serve.Executor(session, ...) "
                "directly for a custom configuration")
        return self._executor

    # ---- execution ---------------------------------------------------------
    def submit(self, queries: Union[Query, Sequence[Query]], key: int = 0,
               on_segment=None, resume: bool = False,
               control=None) -> Union[Result, List[Result]]:
        """Execute one query (returns its ``Result``) or a batch (returns a
        ``Result`` per query, in order).  Same-problem nsga queries of a
        batch merge into one run and banked budget reallocates across the
        batch; scalarized queries run one by one after them.  ``key`` is
        the integer seed of the submission; ``on_segment`` streams every
        nsga scan segment's ``SegmentEvent`` as it completes, and one
        completion event per scalarized query.  ``resume=True`` checkpoints
        every nsga segment and restores a matching checkpoint on entry: a
        stopped or killed submission re-submitted with the same queries and
        ``key`` spends only the residual budget and lands on the
        bit-identical front.  ``control`` (a ``service.RunControl``) stops
        at the next segment boundary; those results carry
        ``provenance.interrupted=True``.

        With a journal attached, the submission journals one ``plan``
        record per query, one ``segment`` record per segment boundary, one
        ``result`` record per answer and a final ``metrics`` snapshot,
        under its own run id (``obs.run_context``)."""
        single = isinstance(queries, Query)
        qs: List[Query] = [queries] if single else list(queries)
        if not qs:
            return []
        rid = f"{self._sid}.{next(self._run_seq)}"
        with obs.sink_attached(self._journal), obs.run_context(rid), \
                obs.span("session.submit", queries=len(qs)):
            out = self._submit_impl(qs, int(key), on_segment, single,
                                    resume, control)
            if obs.active():
                for r in out:
                    pv = r.provenance
                    obs.emit(dict(
                        type="result", key=pv.cache_key, engine=pv.engine,
                        from_cache=pv.from_cache, n_evals=pv.n_evals_run,
                        n_evals_banked=pv.n_evals_banked,
                        n_evals_realloc=pv.n_evals_realloc,
                        plateaued=pv.plateaued, elapsed_s=pv.elapsed_s,
                        interrupted=pv.interrupted,
                        front_size=int(len(r.front_objs))))
                obs.emit(dict(type="metrics",
                              snapshot=obs.REGISTRY.snapshot()))
            for r in out:
                obs.observe("session.time_to_front_s",
                            r.provenance.elapsed_s)
        return out[0] if single else out

    def _submit_impl(self, qs: List[Query], key: int, on_segment,
                     single: bool, resume: bool, control) -> List[Result]:
        # per-query tech overrides route to sibling sessions (same cache
        # directory, distinct tech digests, so distinct archives); each
        # routed group's stream domain-separates on its label
        routed: Dict[str, Tuple["Session", List[int]]] = {}
        for i, q in enumerate(qs):
            s = self._session_for(q.tech)
            if s is not self:
                routed.setdefault(s.tech_label, (s, []))[1].append(i)
        if routed:
            results: Dict[int, Result] = {}
            mine = [i for i, q in enumerate(qs)
                    if self._session_for(q.tech) is self]
            if mine:
                for i, r in zip(mine, self._submit_impl(
                        [qs[i] for i in mine], key, on_segment, False,
                        resume, control)):
                    results[i] = r
            for label, (s, idxs) in routed.items():
                k2 = fold_in(key, zlib.crc32(label.encode()) & 0x7FFFFFFF)
                for i, r in zip(idxs, s._submit_impl(
                        [qs[i] for i in idxs], k2, on_segment,
                        single and len(idxs) == len(qs), resume, control)):
                    results[i] = r
            return [results[i] for i in range(len(qs))]
        if obs.active():        # journal the plan of record for every query
            for q in qs:        # before the engines run (read-only)
                self.plan(q)
        nsga_idx = [i for i, q in enumerate(qs)
                    if q.resolved_engine() == "nsga"]
        for i, q in enumerate(qs):          # validate the whole batch first
            if i in nsga_idx:
                _check_nsga(q)
            else:
                _validate_scalarized(q, q.resolved_engine())
        override = {q.policy for q in qs if q.policy is not None}
        if len(override) > 1:
            raise ValueError("one submission takes at most one "
                             "BudgetPolicy override")
        results: Dict[int, Result] = {}
        if nsga_idx:
            svc = self.service
            saved = svc.policy
            if override:
                svc.policy = next(iter(override))
            try:
                ers = svc.run_queries(
                    [self._to_explore_query(qs[i]) for i in nsga_idx],
                    key=key, on_segment=on_segment, resume=resume,
                    control=control)
            finally:
                svc.policy = saved
            for i, er in zip(nsga_idx, ers):
                results[i] = self._wrap(er)
        for i, q in enumerate(qs):
            if i in results:
                continue
            # a single query takes the caller's key verbatim; batched
            # scalarized queries draw from a domain-separated stream so
            # they never collide with run_queries' per-group folds
            k = key if single else fold_in(fold_in(key, 0x5ca1a2), i)
            results[i] = self._run_scalarized(q, q.resolved_engine(), k,
                                              on_segment)
        return [results[i] for i in range(len(qs))]

    @staticmethod
    def _to_explore_query(q: Query) -> ExploreQuery:
        p = q.problem
        return ExploreQuery(p.graph, p.objectives, int(q.budget), p.ch_max,
                            p.space_kwargs, q.transfer, spec=p.spec,
                            space=p.space, megabatch=q.megabatch,
                            surrogate=dict(q.engine_opts or {}).get(
                                "surrogate"))

    def _wrap(self, er: ExploreResult) -> Result:
        return Result(
            objectives=er.objectives,
            front_objs=er.front_objs, front_metrics=er.front_metrics,
            front_designs=er.front_designs, trace=er.trace,
            provenance=Provenance(
                cache_key=er.cache_key, engine="nsga",
                from_cache=er.from_cache, n_evals_run=er.n_evals_run,
                n_evals_banked=er.n_evals_banked,
                n_evals_realloc=er.n_evals_realloc,
                transferred_from=er.transferred_from,
                n_transfer_seeds=er.n_transfer_seeds,
                plateaued=er.plateaued, elapsed_s=er.elapsed_s,
                interrupted=er.interrupted,
                surrogate_used=er.surrogate_used,
                surrogate_hits=er.surrogate_hits,
                surrogate_fallbacks=er.surrogate_fallbacks,
                tech=self.tech_label),
            raw=er)

    def _run_scalarized(self, q: Query, engine: str, key: int,
                        on_segment=None) -> Result:
        """Run one ``bo_sa`` / ``two_stage`` query on the service's device
        and wrap its ``SearchResult``: the best design, objective and
        metrics, the front of ``Query.archive`` when one was passed (else
        the single incumbent), one completion ``SegmentEvent``."""
        p = q.problem
        svc = self.service
        ck = svc.problem_key(p.spec, p.space)
        opts = dict(q.engine_opts or {})
        t0 = time.perf_counter()
        if engine == "two_stage":
            sr = _two_stage_impl(p.spec, p.space, key, tech=svc.tech,
                                 archive=q.archive,
                                 seed_designs=q.seed_designs,
                                 device=svc.device, **opts)
        else:
            sr = _optimize_impl(p.spec, p.space, key,
                                weights=q.weights or OBJ_EDP,
                                tech=svc.tech, archive=q.archive,
                                seed_designs=q.seed_designs,
                                device=svc.device, **opts)
        elapsed = time.perf_counter() - t0
        cb = ExplorationService._segment_cb(on_segment, ck, engine)
        if cb is not None:
            # one completion event: scalarized engines have no segments (the
            # shared wrapper journals it and contains callback failures)
            cb(0, sr.trace, elapsed, False)
        n_evals = int(sr.trace.n_evals[-1]) if len(sr.trace.n_evals) else 0
        idx = [METRIC_KEYS.index(o) for o in p.objectives]
        if q.archive is not None and len(q.archive) > 0:
            designs, metrics = q.archive.front()
            cols = metrics[:, idx]
            keep = pareto_front(cols) if len(cols) else []
            front_objs, front_metrics = cols[keep], metrics[keep]
            front_designs = [{k: v[i] for k, v in designs.items()}
                             for i in keep]
        else:                           # single-incumbent front
            row = np.asarray([[float(sr.metrics[k]) for k in METRIC_KEYS]],
                             np.float64)
            front_objs, front_metrics = row[:, idx], row
            front_designs = [{k: v.cpu().numpy()
                              for k, v in sr.design.items()}]
        return Result(
            objectives=p.objectives,
            front_objs=front_objs, front_metrics=front_metrics,
            front_designs=front_designs, trace=sr.trace,
            provenance=Provenance(
                cache_key=ck, engine=engine, from_cache=False,
                n_evals_run=n_evals, n_evals_banked=0, n_evals_realloc=0,
                transferred_from=(),
                n_transfer_seeds=len(q.seed_designs or ()),
                plateaued=False, elapsed_s=elapsed, tech=self.tech_label),
            best_design={k: v.cpu().numpy() for k, v in sr.design.items()},
            best_objective=sr.objective, best_metrics=sr.metrics, raw=sr)


def _scalarized_evals(query: Query) -> int:
    """Planned evaluation spend of a scalarized query (an estimate: the
    two-stage selector's stage-2 count depends on the data)."""
    opts = dict(query.engine_opts or {})
    if query.resolved_engine() == "two_stage":
        sa = opts.get("sa", SAConfig(steps=250, chains=4))
        n_scal = max(int(opts.get("n_candidates", 3)), 2)
        return n_scal * (4 + 6) * sa.steps * sa.chains  # n_init=4, n_iter=6
    sa = opts.get("sa", SAConfig())
    n_init = int(opts.get("n_init", 8))
    n_iter = int(opts.get("n_iter", 24))
    bo = opts.get("bo_fields", None)
    has_bo = True if bo is None else len(tuple(bo)) > 0
    return (n_init + (n_iter if has_bo else 0)) * sa.steps * sa.chains


# ---------------------------------------------------------------------------
# module-level conveniences over a process-wide default session
# ---------------------------------------------------------------------------
_DEFAULT_SESSION: Optional[Session] = None


def session(**kwargs) -> Session:
    """The process-wide default ``Session`` (kwargs only on first
    construction)."""
    global _DEFAULT_SESSION
    if _DEFAULT_SESSION is None:
        _DEFAULT_SESSION = Session(**kwargs)
    elif kwargs:
        raise RuntimeError(
            "the default session is already initialized; construct "
            "Session(...) directly for a custom configuration")
    return _DEFAULT_SESSION


def plan(query: Query) -> Plan:
    """``session().plan(query)``."""
    return session().plan(query)


def submit(queries: Union[Query, Sequence[Query]], key: int = 0,
           on_segment=None) -> Union[Result, List[Result]]:
    """``session().submit(queries)``."""
    return session().submit(queries, key=key, on_segment=on_segment)


__all__ = [
    "ENGINES", "NeighborPlan", "Plan", "Problem", "Provenance", "Query",
    "Result", "SegmentEvent", "SegmentPlan", "Session", "plan", "session",
    "submit",
]
