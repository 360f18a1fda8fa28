"""One front door: the declarative Problem / Query / Session API, as
``repro.explore.api`` has it, for the NSGA engine and the scalarized
engines (re-exported at ``repro_torch.api``).

* ``Problem``  — a canonical, hashable statement of *what* to search:
  workload graph + objectives + ``DesignSpace`` bounds + padded spec
  space.  Content-addressed (``Problem.key()``, equal to the reference's
  key for the same problem).
* ``Query``    — a request against a problem: evaluation ``budget`` and
  ``engine`` (``"nsga"``, ``"bo_sa"``, ``"two_stage"``, or ``"auto"``:
  ``bo_sa`` with weights, ``nsga`` without).
* ``Session``  — owns an ``ExplorationService`` on a device;
  ``submit(query | [queries])`` returns one ``Result`` per query with a
  ``Provenance`` record of the cache accounting.  NSGA queries go through
  the service; scalarized queries run the BO x SA engine
  (``core.optimizer``) on the service's device and never touch the archive
  cache.

``Session.plan``, ``submit_async``, transfer, seed designs, surrogate
gating, resume, journals and per-query tech overrides are not ported yet:
asking for one raises ``NotImplementedError`` naming it.  Nothing is
dropped silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.encoding import DesignSpace
from ..core.evaluate import SystemSpec
from ..core.optimizer import (METRIC_KEYS, OBJ_EDP, _optimize_impl,
                              _two_stage_impl)
from ..core.workload import WorkloadGraph
from ..runtime import fold_in
from .archive import ConvergenceTrace, pareto_front, spec_space_key
from .service import (DEFAULT_OBJECTIVES, BudgetPolicy, ExplorationService,
                      ExploreQuery, ExploreResult, SegmentEvent, not_ported)

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
    ``budget`` and ``policy`` size the nsga engine; ``weights``,
    ``archive`` and ``engine_opts`` (``n_init``, ``n_iter``, ``sa``,
    ``bo_fields``, ``sa_fields``, ``init_design`` for ``bo_sa``;
    ``n_candidates``, ``sa`` for ``two_stage``) the scalarized ones.
    ``transfer``, ``seed_designs`` and ``tech`` exist for the reference's
    other options and raise ``NotImplementedError`` when set."""
    problem: Problem
    budget: int = 2048
    engine: str = "auto"
    transfer: bool = False
    weights: Optional[Tuple[float, ...]] = None
    seed_designs: Optional[Sequence[Dict]] = None
    policy: Optional[BudgetPolicy] = None
    archive: Optional[object] = None
    engine_opts: Optional[Dict] = None
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
class Provenance:
    """Where a ``Result`` came from: the engine, the archive it was served
    from, and the cache accounting (the reference's fields; transfer and
    reallocation stay at their zero values in the port)."""
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
    """Raise for an option the nsga engine does not take (``ValueError``,
    as the reference) or the port does not run yet."""
    opts = dict(q.engine_opts or {})
    if "surrogate" in opts:
        raise not_ported("surrogate gating (engine_opts['surrogate'])")
    if q.weights is not None or q.seed_designs or q.archive is not None \
            or opts:
        raise ValueError(
            "weights / seed_designs / archive / engine_opts apply to the "
            "scalarized engines; the nsga engine takes budget / transfer / "
            "policy")
    if q.transfer:
        raise not_ported("cross-workload transfer (Query.transfer)")
    if q.tech is not None:
        raise not_ported("per-query tech overrides (Query.tech)")


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
    if q.seed_designs:
        raise not_ported("seed designs (Query.seed_designs)")
    if q.tech is not None:
        raise not_ported("per-query tech overrides (Query.tech)")


class Session:
    """The front door: submit declarative queries.

    Wraps an ``ExplorationService`` (constructed from the given kwargs —
    ``cache_dir``, ``capacity``, ``nsga``, ``tech``, ``policy`` — when not
    supplied) that runs on ``device`` (default ``"cuda"``; without a card
    it raises unless ``device="cpu"`` is passed)."""

    def __init__(self, service: Optional[ExplorationService] = None,
                 journal=None, device="cuda", **service_kwargs):
        if journal:
            raise not_ported("run journals (Session(journal=...))")
        if service is None:
            service = ExplorationService(device=device, **service_kwargs)
        self.service = service

    def plan(self, query: Query):
        raise not_ported("Session.plan")

    def submit_async(self, query: Query, key=None, deadline_s=None):
        raise not_ported("Session.submit_async")

    def submit(self, queries: Union[Query, Sequence[Query]], key: int = 0,
               on_segment=None, resume: bool = False,
               control=None) -> Union[Result, List[Result]]:
        """Execute one query (returns its ``Result``) or a batch (returns a
        ``Result`` per query, in order).  Same-problem nsga queries of a
        batch merge into one run; scalarized queries run one by one after
        them.  ``key`` is the integer seed of the submission;
        ``on_segment`` streams every nsga scan segment's ``SegmentEvent``
        as it completes, and one completion event per scalarized query."""
        if resume:
            raise not_ported("checkpoint resume (submit(resume=True))")
        if control is not None:
            raise not_ported("cooperative stop (submit(control=...))")
        single = isinstance(queries, Query)
        qs: List[Query] = [queries] if single else list(queries)
        if not qs:
            return []
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
                    key=int(key), on_segment=on_segment)
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
            k = int(key) if single else fold_in(fold_in(key, 0x5ca1a2), i)
            results[i] = self._run_scalarized(q, q.resolved_engine(), k,
                                              on_segment)
        out = [results[i] for i in range(len(qs))]
        return out[0] if single else out

    @staticmethod
    def _to_explore_query(q: Query) -> ExploreQuery:
        p = q.problem
        return ExploreQuery(p.graph, p.objectives, int(q.budget), p.ch_max,
                            p.space_kwargs, spec=p.spec, space=p.space)

    @staticmethod
    def _wrap(er: ExploreResult) -> Result:
        return Result(
            objectives=er.objectives,
            front_objs=er.front_objs, front_metrics=er.front_metrics,
            front_designs=er.front_designs, trace=er.trace,
            provenance=Provenance(
                cache_key=er.cache_key, engine="nsga",
                from_cache=er.from_cache, n_evals_run=er.n_evals_run,
                n_evals_banked=er.n_evals_banked, n_evals_realloc=0,
                transferred_from=(), n_transfer_seeds=0,
                plateaued=er.plateaued, elapsed_s=er.elapsed_s),
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
                                 archive=q.archive, device=svc.device,
                                 **opts)
        else:
            sr = _optimize_impl(p.spec, p.space, key,
                                weights=q.weights or OBJ_EDP,
                                tech=svc.tech, archive=q.archive,
                                device=svc.device, **opts)
        elapsed = time.perf_counter() - t0
        if on_segment is not None:
            # one completion event: scalarized engines have no segments
            on_segment(SegmentEvent(ck, 0, sr.trace, engine,
                                    elapsed_s=elapsed, seq=0))
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
                transferred_from=(), n_transfer_seeds=0, plateaued=False,
                elapsed_s=elapsed),
            best_design={k: v.cpu().numpy() for k, v in sr.design.items()},
            best_objective=sr.objective, best_metrics=sr.metrics, raw=sr)


__all__ = ["ENGINES", "Problem", "Provenance", "Query", "Result",
           "SegmentEvent", "Session"]
