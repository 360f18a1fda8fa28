"""One front door: the declarative Problem / Query / Session API, as
``repro.explore.api`` has it, for the NSGA engine (re-exported at
``repro_torch.api``).

* ``Problem``  — a canonical, hashable statement of *what* to search:
  workload graph + objectives + ``DesignSpace`` bounds + padded spec
  space.  Content-addressed (``Problem.key()``, equal to the reference's
  key for the same problem).
* ``Query``    — a request against a problem: evaluation ``budget`` and
  ``engine`` (``"nsga"``, or ``"auto"`` without weights).
* ``Session``  — owns an ``ExplorationService`` on a device;
  ``submit(query | [queries])`` returns one ``Result`` per query with a
  ``Provenance`` record of the cache accounting.

The scalarized engines (``bo_sa``, ``two_stage``), ``Session.plan``,
``submit_async``, transfer, seeds, surrogate gating, resume, journals and
per-query tech overrides are not ported yet: asking for one raises
``NotImplementedError`` naming it.  Nothing is dropped silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.encoding import DesignSpace
from ..core.evaluate import SystemSpec
from ..core.optimizer import METRIC_KEYS
from ..core.workload import WorkloadGraph
from .archive import ConvergenceTrace, spec_space_key
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

    ``engine`` is ``"nsga"`` (the multi-objective front explorer) or
    ``"auto"`` (``nsga`` unless ``weights`` are given).  ``budget`` is the
    evaluation budget; ``policy`` overrides the session's ``BudgetPolicy``
    for this submission.  The remaining fields exist for the reference's
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
    the provenance, and the engine-native ``ExploreResult`` as ``raw``."""
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


def _check_ported(q: Query) -> None:
    """Raise for any option of ``q`` the port does not run yet."""
    eng = q.resolved_engine()
    if eng != "nsga":
        raise not_ported(f"the {eng!r} engine")
    checks = ((q.transfer, "cross-workload transfer (Query.transfer)"),
              (q.seed_designs, "seed designs (Query.seed_designs)"),
              (q.archive is not None, "archive passthrough (Query.archive)"),
              (q.engine_opts, "engine options / surrogate gating "
                              "(Query.engine_opts)"),
              (q.tech is not None, "per-query tech overrides (Query.tech)"))
    for asked, what in checks:
        if asked:
            raise not_ported(what)


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
        ``Result`` per query, in order).  Same-problem queries of a batch
        merge into one run.  ``key`` is the integer seed of the
        submission; ``on_segment`` streams every scan segment's
        ``SegmentEvent`` as it completes."""
        if resume:
            raise not_ported("checkpoint resume (submit(resume=True))")
        if control is not None:
            raise not_ported("cooperative stop (submit(control=...))")
        single = isinstance(queries, Query)
        qs: List[Query] = [queries] if single else list(queries)
        if not qs:
            return []
        for q in qs:                        # validate the whole batch first
            _check_ported(q)
        override = {q.policy for q in qs if q.policy is not None}
        if len(override) > 1:
            raise ValueError("one submission takes at most one "
                             "BudgetPolicy override")
        svc = self.service
        saved = svc.policy
        if override:
            svc.policy = next(iter(override))
        try:
            ers = svc.run_queries([self._to_explore_query(q) for q in qs],
                                  key=int(key), on_segment=on_segment)
        finally:
            svc.policy = saved
        out = [self._wrap(er) for er in ers]
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


__all__ = ["ENGINES", "Problem", "Provenance", "Query", "Result",
           "SegmentEvent", "Session"]
