"""Monad's nested optimization engine (paper Sec. IV-C, Fig. 6b): the port
of ``repro.core.optimizer``.

Outer loop: **Bayesian optimization** over the low-dimensional fields
(shape, spatial, packaging, network family) — a Gaussian-process surrogate
with the Matérn-5/2 covariance and the *probability of improvement*
acquisition.  Each BO sample is evaluated by a **simulated-annealing** run
over the high-dimensional fields (order, tiling, pipe, placement) with the
low-dimensional fields frozen.

Where the reference jits a ``lax.scan`` over vmapped chains, ``make_sa``
runs a Python loop over the SA steps with the chains as the population
dimension of the batched ``mutate`` / ``evaluate_arrays``; the loop makes
no host synchronization until the run's best is read.  The GP covariance
goes through the Hopper ``gp_cov`` kernel (``kernels/gp_cov``) on the card
and its plain version on the CPU; the Cholesky factor and the triangular
solves are library linear algebra in float32, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..explore.archive import ConvergenceTrace, pareto_front  # noqa: F401
from ..kernels.gp_cov import ops as gp_cov_ops
from ..runtime import fold_in, generator, resolve_device
from .constants import DEFAULT_TECH
from .encoding import (BO_FIELDS, SA_FIELDS, DesignSpace,
                       feasibility_penalty, mutate, random_design, repair)
from .evaluate import SystemSpec, evaluate_arrays, spec_tensors
from .network import N_FAMILIES

F = torch.float32

# the objective axes every engine (scalarized BO x SA, NSGA-II fronts,
# Pareto archives) agrees on, in canonical order
METRIC_KEYS = ("latency_ns", "energy_pj", "cost_usd", "area_mm2")

# objective weights over log-metrics: (latency, energy, cost, area)
OBJ_EDP = (1.0, 1.0, 0.0, 0.0)
OBJ_LATENCY = (1.0, 0.0, 0.0, 0.0)
OBJ_ENERGY = (0.0, 1.0, 0.0, 0.0)
OBJ_COST_EDP = (1.0, 1.0, 1.0, 0.0)     # cost-effectiveness (Fig. 9/10)


def metric_stack(metrics: Dict) -> torch.Tensor:
    """(..., 4) raw metric vectors in ``METRIC_KEYS`` order (archive rows)."""
    return torch.stack([metrics[k].to(F) for k in METRIC_KEYS], dim=-1)


def log_metric_stack(metrics: Dict) -> torch.Tensor:
    """(..., 4) clipped log-metric vectors — the shared evaluation path of
    the search engines."""
    return torch.stack([torch.log(metrics[k].to(F).clamp_min(1e-3))
                        for k in METRIC_KEYS], dim=-1)


def penalty_log(space: DesignSpace, design: Dict, metrics: Dict):
    """(P,) log feasibility penalty (shared by scalarized + front
    explorers)."""
    return torch.log(feasibility_penalty(space, design, metrics))


def objective_from_metrics(space: DesignSpace, design: Dict, metrics: Dict,
                           weights) -> torch.Tensor:
    """(P,) sum_i w_i * log(metric_i) + 8 log(feasibility penalty);
    minimize.  ``weights`` is a (4,) tensor on the metrics' device or a
    sequence of numbers."""
    lm = log_metric_stack(metrics)
    w = torch.as_tensor(weights, dtype=F, device=lm.device)
    return (w * lm).sum(-1) + 8.0 * penalty_log(space, design, metrics)


# ---------------------------------------------------------------------------
# simulated annealing (a step loop over a population of chains)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SAConfig:
    steps: int = 400
    chains: int = 8
    t0: float = 1.0
    t1: float = 0.01


def _on(design: Dict, dev) -> Dict[str, torch.Tensor]:
    """A design (arrays or tensors) as int32 tensors on ``dev``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=dev, dtype=torch.int32)
            for k, v in design.items()}


def make_sa(spec: SystemSpec, space: DesignSpace,
            fields: Tuple[str, ...] = SA_FIELDS,
            sa: SAConfig = SAConfig(), tech=None, device="cuda"):
    """Build an SA runner on ``device``: ``(seed, d0, weights) -> (best
    design, best objective)``.  ``fields`` is the mutable subset.

    ``d0`` is one design (no population dim), ``weights`` the 4 objective
    weights.  ``sa.chains`` chains start from ``d0`` and anneal together as
    one population; every step mutates each chain once, evaluates all of
    them in one call and applies the reference's accept rule.  The run
    draws from one ``torch.Generator`` on the device, seeded from the
    integer ``seed``; the best design comes back without a population dim
    on the device, its objective as a 0-d tensor.

    The runner's parts are exposed for tests: ``run.start(seed, d0,
    weights)`` returns the run's state and ``run.steps(state, s0, s1)``
    takes steps ``s0 .. s1 - 1`` on it in place, with no host sync."""
    tech = tech or DEFAULT_TECH
    dev = resolve_device(device)
    dims = (spec.W, spec.CH, spec.E)
    arr = spec_tensors(spec.arrays, dev)
    nl = arr["loopmask"].sum(1).to(torch.int32)
    temps = torch.exp(torch.linspace(math.log(sa.t0), math.log(sa.t1),
                                     sa.steps, dtype=F, device=dev))
    C = sa.chains

    def obj(design, w):
        m = evaluate_arrays(arr, design, dims, tech)
        return objective_from_metrics(space, design, m, w)

    def keep(mask, new, old):
        return {k: torch.where(mask.view((C,) + (1,) * (v.dim() - 1)),
                               new[k], v) for k, v in old.items()}

    def start(seed: int, d0: Dict, weights) -> Dict:
        w = torch.as_tensor(weights, dtype=F, device=dev)
        cur = {k: v.expand((C,) + v.shape).clone()
               for k, v in _on(d0, dev).items()}
        o_cur = obj(cur, w)
        return dict(gen=generator(fold_in(seed, 0), dev), w=w, cur=cur,
                    o_cur=o_cur, best=cur, o_best=o_cur)

    def steps(st: Dict, s0: int, s1: int) -> None:
        gen, w = st["gen"], st["w"]
        for s in range(s0, s1):
            new = mutate(gen, st["cur"], space, fields, nl=nl,
                         bounds=arr["bounds"])
            o_new = obj(new, w)
            u = torch.rand(C, generator=gen, device=dev)
            accept = (o_new < st["o_cur"]) | (
                u < torch.exp((st["o_cur"] - o_new) / temps[s]))
            st["cur"] = keep(accept, new, st["cur"])
            st["o_cur"] = torch.where(accept, o_new, st["o_cur"])
            better = o_new < st["o_best"]
            st["best"] = keep(better, new, st["best"])
            st["o_best"] = torch.where(better, o_new, st["o_best"])

    def run(seed: int, d0: Dict, weights):
        st = start(seed, d0, weights)
        steps(st, 0, sa.steps)
        i = torch.argmin(st["o_best"])
        return {k: v[i] for k, v in st["best"].items()}, st["o_best"][i]

    run.start, run.steps = start, steps
    return run


# ---------------------------------------------------------------------------
# Gaussian process + probability of improvement
# ---------------------------------------------------------------------------
def matern52(X1, X2, lengthscale):
    """Matérn-5/2 K(X1, X2) — the ``gp_cov`` kernel on the card, its plain
    version on the CPU (the same function as the reference's
    ``optimizer.matern52``)."""
    return gp_cov_ops.matern52(X1, X2, lengthscale)


def gp_posterior(X, y, Xq, lengthscale=0.3, noise=1e-4, cov_fn=None):
    """GP posterior mean/std at query points (standardized y).  ``X``
    (n, d), ``y`` (n,), ``Xq`` (q, d): float32 tensors on one device."""
    cov = cov_fn or matern52
    mu0 = y.mean()
    sd = y.std(correction=0).clamp_min(1e-9)
    yn = (y - mu0) / sd
    K = cov(X, X, lengthscale) + noise * torch.eye(
        X.shape[0], dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(K)
    a = torch.cholesky_solve(yn[:, None], L)[:, 0]
    Kq = cov(Xq, X, lengthscale)
    mu = Kq @ a
    v = torch.linalg.solve_triangular(L, Kq.T, upper=False)
    var = (1.0 - (v * v).sum(0)).clamp_min(1e-10)
    return mu * sd + mu0, torch.sqrt(var) * sd


def prob_improvement(mu, sigma, best, xi=0.01):
    """The normal CDF of the improvement z-score, through ``erfc`` so the
    lower tail keeps its value in float32 (``torch.special.ndtr`` rounds
    it to 0 there, and an argmax over candidates that all lie in that tail
    would then pick the first one)."""
    z = (best - xi - mu) / sigma.clamp_min(1e-9)
    return 0.5 * torch.special.erfc(-z * (1.0 / math.sqrt(2.0)))


# ---------------------------------------------------------------------------
# low-dim field <-> unit-cube vector codec for the BO surrogate (host numpy)
# ---------------------------------------------------------------------------
def _bo_dims(space: DesignSpace, fields) -> int:
    W = space.W
    n = 0
    for f in fields:
        if f in ("shape", "spatial"):
            n += 6 * W
        elif f in ("packaging", "family"):
            n += 1
    return n


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def encode_bo(space: DesignSpace, design: Dict, fields) -> np.ndarray:
    out = []
    mx = np.asarray(space.max_shape, np.float64)
    nl = np.maximum(space.n_loops.astype(np.float64), 1)
    for f in fields:
        if f == "shape":
            out.append((_host(design["shape"]) - 1) / np.maximum(mx - 1, 1))
        elif f == "spatial":
            out.append(_host(design["spatial"]) / nl[:, None])
        elif f == "packaging":
            out.append(_host(design["packaging"]).reshape(1) / 2.0)
        elif f == "family":
            out.append(_host(design["family"]).reshape(1)
                       / (N_FAMILIES - 1))
    return np.concatenate([np.ravel(o) for o in out]).astype(np.float64)


def decode_bo(space: DesignSpace, z: np.ndarray, base: Dict, fields,
              device="cuda") -> Dict:
    """The design ``base`` with ``fields`` set from the unit-cube vector
    ``z``, as int32 tensors on ``device``."""
    d = {k: _host(v).copy() for k, v in base.items()}
    W = space.W
    mx = np.asarray(space.max_shape, np.float64)
    nl = np.maximum(space.n_loops.astype(np.float64), 1)
    i = 0
    for f in fields:
        if f == "shape":
            blk = z[i:i + 6 * W].reshape(W, 6)
            d["shape"] = np.clip(
                np.rint(blk * np.maximum(mx - 1, 1) + 1), 1, mx
            ).astype(np.int32)
            i += 6 * W
        elif f == "spatial":
            blk = z[i:i + 6 * W].reshape(W, 6)
            d["spatial"] = np.clip(np.rint(blk * nl[:, None]), 0,
                                   nl[:, None] - 1).astype(np.int32)
            i += 6 * W
        elif f == "packaging":
            if space.fixed_packaging < 0:
                d["packaging"] = np.int32(np.clip(np.rint(z[i] * 2), 0, 2))
            i += 1
        elif f == "family":
            if space.fixed_family < 0:
                d["family"] = np.int32(np.clip(
                    np.rint(z[i] * (N_FAMILIES - 1)), 0, N_FAMILIES - 1))
            i += 1
    return _on(d, resolve_device(device))


# ---------------------------------------------------------------------------
# the full nested engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SearchResult:
    design: Dict                  # one design, int32 tensors on the device
    objective: float
    metrics: Dict                 # numpy values of the best design
    history: list                 # (iteration, best objective) trace
    trace: Optional[ConvergenceTrace] = None   # running best + cumulative
    #                               SA evaluations (repro_torch.explore.
    #                               archive), comparable with NSGA traces


def optimize(spec: SystemSpec, space: DesignSpace, key: int,
             weights=OBJ_EDP,
             bo_fields: Tuple[str, ...] = BO_FIELDS,
             sa_fields: Tuple[str, ...] = SA_FIELDS,
             n_init: int = 8, n_iter: int = 24,
             sa: SAConfig = SAConfig(), tech=None,
             init_design: Optional[Dict] = None,
             seed_designs: Optional[Sequence[Dict]] = None,
             archive=None, device="cuda") -> SearchResult:
    """DEPRECATED shim over the ``bo_sa`` engine backend — routes through
    ``repro_torch.api.Session.submit`` (``Query(Problem.from_spec(spec,
    space), engine="bo_sa", ...)``) on ``device`` and returns the
    backend's ``SearchResult`` unchanged.  See ``_optimize_impl`` for the
    engine itself."""
    warnings.warn(
        "legacy entry point repro_torch.core.optimizer.optimize() is "
        "deprecated; use repro_torch.api: Session(tech=...).submit(Query("
        "Problem.from_spec(spec, space), engine=\"bo_sa\", weights=..., "
        "engine_opts=dict(n_init=..., n_iter=..., sa=...)))",
        DeprecationWarning, stacklevel=2)
    from ..explore.api import Problem, Query, Session
    q = Query(Problem.from_spec(spec, space), engine="bo_sa",
              weights=tuple(float(w) for w in weights),
              seed_designs=seed_designs, archive=archive,
              engine_opts=dict(bo_fields=bo_fields, sa_fields=sa_fields,
                               n_init=n_init, n_iter=n_iter, sa=sa,
                               init_design=init_design))
    return Session(tech=tech, device=device).submit(q, key=key).raw


def _optimize_impl(spec: SystemSpec, space: DesignSpace, key: int,
                   weights=OBJ_EDP,
                   bo_fields: Tuple[str, ...] = BO_FIELDS,
                   sa_fields: Tuple[str, ...] = SA_FIELDS,
                   n_init: int = 8, n_iter: int = 24,
                   sa: SAConfig = SAConfig(), tech=None,
                   init_design: Optional[Dict] = None,
                   seed_designs: Optional[Sequence[Dict]] = None,
                   archive=None, device="cuda") -> SearchResult:
    """Nested BO(low-dim) x SA(high-dim) search (paper Fig. 6b) on
    ``device``.

    ``key`` is an integer seed: it seeds the host-side numpy generator as
    the reference seeds its own (with the key's last word, the seed), so
    the restart seeds and the BO candidate draws follow the same numpy
    stream.  Setting ``bo_fields=()`` degenerates to pure SA over
    ``sa_fields``.  ``init_design`` replaces the first random restart.
    ``seed_designs`` (e.g. designs migrated out of a neighbor spec's
    archive with ``encoding.migrate``) replace the next leading random
    restarts, each ``repair``-ed into this space first; at most ``n_init``
    entries are consumed, one SA refinement each.  ``archive`` (a ``repro_torch.explore.archive.ParetoArchive``) records
    every SA-refined design with its raw metric vector, masked to the
    feasible ones."""
    tech = tech or DEFAULT_TECH
    dev = resolve_device(device)
    dims = (spec.W, spec.CH, spec.E)
    arr = spec_tensors(spec.arrays, dev)
    sa_run = make_sa(spec, space, sa_fields, sa, tech, device=dev)
    rng = np.random.default_rng(int(key))

    X, Y, designs = [], [], []
    history = []
    inits = ([] if init_design is None else [init_design]) + [
        repair(d, space) for d in (seed_designs or [])]

    def eval_point(d0):
        d_best, o_best = sa_run(int(rng.integers(2 ** 31)), d0, weights)
        return d_best, float(o_best)        # one sync per SA run

    n_bo = _bo_dims(space, bo_fields)
    for i in range(n_init):
        d0 = random_design(int(rng.integers(2 ** 31)), space, device=dev)
        if i < len(inits):
            d0 = _on(inits[i], dev)
        db, ob = eval_point(d0)
        designs.append(db)
        Y.append(ob)
        if n_bo > 0:
            X.append(encode_bo(space, db, bo_fields))
        history.append((i, float(np.min(Y))))

    if n_bo > 0:
        for i in range(n_iter):
            Xa = torch.as_tensor(np.stack(X), dtype=F, device=dev)
            Ya = torch.as_tensor(np.asarray(Y, np.float64), dtype=F,
                                 device=dev)
            # acquisition: PI over random candidates + perturbations of best
            cand = rng.random((384, n_bo))
            zb = X[int(np.argmin(Y))]
            pert = np.clip(zb[None, :] + rng.normal(0, 0.15, (128, n_bo)),
                           0, 1)
            Z = np.vstack([cand, pert])
            mu, sg = gp_posterior(Xa, Ya, torch.as_tensor(Z, dtype=F,
                                                          device=dev))
            pi = prob_improvement(mu, sg, float(np.min(Y)))
            z = Z[int(torch.argmax(pi))]
            d0 = decode_bo(space, z, designs[int(np.argmin(Y))], bo_fields,
                           device=dev)
            db, ob = eval_point(d0)
            designs.append(db)
            Y.append(ob)
            X.append(encode_bo(space, db, bo_fields))
            history.append((n_init + i, float(np.min(Y))))

    ib = int(np.argmin(Y))
    best = designs[ib]
    m = evaluate_arrays(arr, {k: v[None] for k, v in best.items()}, dims,
                        tech)
    metrics = {k: v[0].detach().cpu().numpy() for k, v in m.items()}
    if archive is not None and designs:
        # one batched evaluation + insert for every SA-refined design
        stacked = {k: torch.stack([d[k] for d in designs]) for k in best}
        mb = evaluate_arrays(arr, stacked, dims, tech)
        feas = feasibility_penalty(space, stacked, mb) <= 1.0 + 1e-6
        archive.insert(stacked, metric_stack(mb), mask=feas)
    return SearchResult(design=best, objective=float(Y[ib]),
                        metrics=metrics, history=history,
                        trace=ConvergenceTrace.from_history(
                            history, evals_per_step=sa.steps * sa.chains))


# ---------------------------------------------------------------------------
# the paper's two-stage flow (Sec. IV-A): the architecture stage keeps a
# Pareto set; the integration stage's design-selector picks from it
# ---------------------------------------------------------------------------
def two_stage_optimize(spec: SystemSpec, space: DesignSpace, key: int,
                       n_candidates: int = 3,
                       sa: SAConfig = SAConfig(steps=250, chains=4),
                       tech=None, archive=None,
                       seed_designs: Optional[Sequence[Dict]] = None,
                       device="cuda") -> SearchResult:
    """DEPRECATED shim over the ``two_stage`` engine backend — routes
    through ``repro_torch.api.Session.submit`` (``Query(..., engine=
    "two_stage")``) on ``device`` and returns the backend's
    ``SearchResult`` unchanged.  See ``_two_stage_impl`` for the engine
    itself (whose nested searches call ``_optimize_impl``, which warns
    nothing)."""
    warnings.warn(
        "legacy entry point repro_torch.core.optimizer.two_stage_optimize() "
        "is deprecated; use repro_torch.api: Session(tech=...).submit(Query("
        "Problem.from_spec(spec, space), engine=\"two_stage\", "
        "engine_opts=dict(n_candidates=..., sa=...)))",
        DeprecationWarning, stacklevel=2)
    from ..explore.api import Problem, Query, Session
    q = Query(Problem.from_spec(spec, space), engine="two_stage",
              seed_designs=seed_designs, archive=archive,
              engine_opts=dict(n_candidates=n_candidates, sa=sa))
    return Session(tech=tech, device=device).submit(q, key=key).raw


def _two_stage_impl(spec: SystemSpec, space: DesignSpace, key: int,
                    n_candidates: int = 3,
                    sa: SAConfig = SAConfig(steps=250, chains=4),
                    tech=None, archive=None,
                    seed_designs: Optional[Sequence[Dict]] = None,
                    device="cuda") -> SearchResult:
    """Stage 1 (architecture): search arch fields under several objective
    scalarizations, keep the Pareto-optimal candidates over
    (latency, energy, area).  Stage 2 (integration): for each kept
    candidate, open the integration fields (packaging/network/placement)
    and optimize EDP; the best pair wins.  ``key`` is an integer seed;
    stage runs draw from ``fold_in(key, i)``.  ``seed_designs`` warm-start
    every stage-1 scalarization's init phase."""
    tech = tech or DEFAULT_TECH
    keys = [fold_in(key, i) for i in range(8)]

    cands, objs = [], []
    weights_list = [OBJ_LATENCY, OBJ_ENERGY, OBJ_EDP,
                    (1.0, 1.0, 0.0, 1.0)][:max(n_candidates, 2)]
    for i, w in enumerate(weights_list):
        r = _optimize_impl(spec, space, keys[i], weights=w,
                           bo_fields=("shape", "spatial"),
                           sa_fields=("order", "tiling", "pipe"),
                           n_init=4, n_iter=6, sa=sa, tech=tech,
                           archive=archive, seed_designs=seed_designs,
                           device=device)
        cands.append(r.design)
        m = r.metrics
        objs.append([float(m["latency_ns"]), float(m["energy_pj"]),
                     float(m["area_mm2"])])
    keep = pareto_front(objs)

    best = None
    for ki, ci in enumerate(keep):
        r = _optimize_impl(spec, space, keys[4 + (ki % 4)], weights=OBJ_EDP,
                           bo_fields=("packaging", "family"),
                           sa_fields=("placement",),
                           n_init=2, n_iter=4, sa=sa, tech=tech,
                           init_design=cands[ci], archive=archive,
                           device=device)
        if best is None or r.objective < best.objective:
            best = r
    best.history.append(("pareto_kept", len(keep)))
    return best
