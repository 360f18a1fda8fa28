"""NSGA-II-style evolutionary front explorer — the port of
``repro.explore.nsga``: ``make_nsga`` (single device, no islands), its
megabatched form ``make_nsga_fused`` and the surrogate-gated
``make_nsga_gated``.

One generation, over a population tensor of width ``pop``:

    variate  (field crossover with a random mate + chained ``mutate`` moves,
              a few random immigrants)
    evaluate (``evaluate_arrays`` over the whole population at once)
    select   (dominance counts through the ``pareto_rank`` kernel, crowding
              distance tie-break, over the 2 x pop parent + child pool)

A Python loop over generations takes the place of ``lax.scan``; nothing in
the loop waits for the device, so a whole segment is queued before the
host reads anything back.  Evaluation and objectives are the path the
reference uses (``log_metric_stack`` + 8 x log feasibility penalty).

**Lanes.**  Where the reference ``vmap``s a whole run over L problems, the
port lays the L populations out lane by lane in one population of L x pop
rows.  Each lane draws from its own ``torch.Generator`` exactly what its
unfused run draws (``runtime.LaneGenerators``), and every row reads its own
problem's spec tensors; everything else runs once for all lanes:
evaluation, the selection's one batched ``pareto_rank`` launch over the
(L, 2 pop, k) pools, crowding, sorts and telemetry.  ``make_nsga`` is the
one-lane case of the same loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.constants import DEFAULT_TECH, tech_key
from ..core.encoding import (ALL_FIELDS, DesignSpace, feasibility_penalty,
                             mutate, random_design)
from ..core.evaluate import SystemSpec, evaluate_arrays, spec_tensors
from ..core.optimizer import METRIC_KEYS, log_metric_stack, metric_stack
from ..runtime import LaneGenerators, generator, rand, resolve_device
from .archive import (BIG, HV_LOG_REF, crowding_distance, dominance_counts,
                      flatten_rows, hypervolume_2d_jit, objective_pairs)
from .surrogate import ensemble_forward

F = torch.float32

# design fields, in a fixed order, for the field-level crossover
_DESIGN_KEYS = ("shape", "spatial", "order", "tiling", "pipe", "logB",
                "packaging", "family", "placement")


@dataclasses.dataclass(frozen=True)
class NSGAConfig:
    pop: int = 64                 # population size (batch width)
    generations: int = 32         # loop length; evals = pop * generations
    fields: Tuple[str, ...] = ALL_FIELDS
    crossover_rate: float = 0.35  # per-field probability of taking the mate
    mutations: int = 2            # chained encoding.mutate moves per child
    immigrants: float = 0.125     # fraction of children replaced by fresh
    #                               random designs (keeps the front spread)
    pmx_placement: bool = False   # placement crossover MIXES both parents'
    #                               permutations (PMX) instead of taking one
    #                               wholesale — permutation validity kept


def pmx(gen, a: torch.Tensor, b: torch.Tensor):
    """Partially-mapped crossover of two batches of permutations (P, n).

    A random segment ``[lo, hi)`` of ``b`` is worked into a child that
    otherwise inherits ``a``: walking the segment, ``b[k]`` is swapped into
    position ``k`` (the classic in-place PMX formulation), so each result
    row is a valid permutation carrying ``b``'s segment and ``a``'s relative
    order elsewhere.  ``gen`` is a generator or a ``LaneGenerators``."""
    P, n = a.shape
    dev = a.device
    i = torch.floor(rand(gen, (P,), dev) * n).long()
    j = torch.floor(rand(gen, (P,), dev) * (n + 1)).long()
    i, j = i.clamp(max=n - 1), j.clamp(max=n)
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    ar = torch.arange(P, device=dev)
    c = a.clone()
    for k in range(n):
        on = (k >= lo) & (k < hi)
        v = b[:, k]
        pos = (c == v[:, None]).to(torch.int8).argmax(1)
        ck = c[:, k].clone()
        c[ar, pos] = torch.where(on, ck, c[ar, pos])
        c[:, k] = torch.where(on, v, c[:, k])
    return c


def _objective_idx(objectives) -> Tuple[int, ...]:
    idx = tuple(METRIC_KEYS.index(o) for o in objectives)
    if not idx:
        raise ValueError("objectives must name at least one metric")
    return idx


# first-execution bookkeeping per runner variant, for the observability
# layer: the first run of a variant in this process loads the kernel
# libraries, creates the CUDA context and warms the allocator and caches,
# so its segment is attributed apart (``compile``), as the reference
# attributes XLA lowering
_RUN_STATE: Dict[tuple, Dict[str, bool]] = {}


def _variant(kind: str, spec: SystemSpec, space: DesignSpace, objectives,
             cfg: "NSGAConfig", tech, device, *extra) -> tuple:
    """One runner variant: its kind, padded dims, objectives, config, tech
    digest, the space's bounds and the device (workload content is not
    part of a variant)."""
    return (kind, (spec.W, spec.CH, spec.E), _objective_idx(objectives),
            cfg, tech_key(tech or DEFAULT_TECH), space.max_shape,
            space.max_logB, space.max_total_pes, space.fixed_packaging,
            space.fixed_family, space.allow_pipeline,
            str(resolve_device(device))) + extra


def has_run(spec: SystemSpec, space: DesignSpace, objectives,
            cfg: "NSGAConfig", tech=None, device="cuda") -> bool:
    """True once a ``make_nsga`` runner of this variant has run in this
    process (what ``compile_state["executed"]`` of a new runner would
    read), without building one."""
    st = _RUN_STATE.get(_variant("nsga", spec, space, objectives, cfg, tech,
                                 device))
    return bool(st and st["executed"])


def _run_state(*variant) -> Dict[str, bool]:
    """The shared ``{"executed": bool}`` record of one runner variant."""
    return _RUN_STATE.setdefault(_variant(*variant), dict(executed=False))


class _Engine:
    """The generation loop shared by every runner, for ``lanes`` problems
    of one padded shape (``lanes == 1``: the plain run, on spec tensors
    shared by the population, step for step the historical one)."""

    def __init__(self, spec: SystemSpec, space: DesignSpace, objectives,
                 cfg: NSGAConfig, tech, device, lanes: int = 1):
        self.space, self.cfg = space, cfg
        self.tech = tech or DEFAULT_TECH
        self.dev = resolve_device(device)
        self.dims = (spec.W, spec.CH, spec.E)
        self.idx = _objective_idx(objectives)
        self.lanes = int(lanes)
        self.obj_idx = torch.as_tensor(self.idx, device=self.dev)
        self.pairs = objective_pairs(len(self.idx))
        self.n_imm = int(round(cfg.pop * cfg.immigrants))
        self.spec_arr = spec_tensors(spec.arrays, self.dev)

    # ---- problem tensors ----------------------------------------------------
    def problem(self, arrays_seq: Sequence):
        """Spec tensors for the population (shared with one lane, per row
        with several) and the (nl, bounds) its variation draws against,
        for pop-row and immigrant-row blocks."""
        arrs = [self.spec_arr if a is None else spec_tensors(a, self.dev)
                for a in arrays_seq]
        if self.lanes == 1:
            arr = arrs[0]
            nl = arr["loopmask"].sum(1).to(torch.int32)
            return arr, (nl, arr["bounds"]), (nl, arr["bounds"])
        N = self.cfg.pop

        def rows(n):                    # each lane's tensors, n rows each
            return {k: torch.stack([a[k] for a in arrs]).repeat_interleave(
                n, 0) for k in arrs[0]}
        arr = rows(N)
        nl = arr["loopmask"].sum(-1).to(torch.int32)
        imm = rows(self.n_imm) if self.n_imm else arr
        nl_imm = imm["loopmask"].sum(-1).to(torch.int32)
        return arr, (nl, arr["bounds"]), (nl_imm, imm["bounds"])

    # ---- variation ------------------------------------------------------------
    def variate(self, gen, pop: Dict, var) -> Dict:
        """Children of ``pop`` (L x N rows): whole-field crossover with a
        random mate of the same lane, then a few chained single-field
        ``mutate`` moves (the SA neighborhood)."""
        cfg, dev, N, L = self.cfg, self.dev, self.cfg.pop, self.lanes
        if L == 1:
            partners = torch.randint(0, N, (N,), generator=gen, device=dev)
        else:
            partners = torch.cat([
                torch.randint(0, N, (N,), generator=g, device=dev) + i * N
                for i, g in enumerate(gen.gens)])
        mates = {k: v[partners] for k, v in pop.items()}
        children = {}
        for f in _DESIGN_KEYS:
            a, b = pop[f], mates[f]
            take = rand(gen, (L * N,), dev) < cfg.crossover_rate
            if f == "placement" and cfg.pmx_placement:
                # PMX keeps the child a valid permutation while mixing both
                # parents' placements (a whole-field take copies one)
                children[f] = torch.where(take[:, None], pmx(gen, a, b), a)
            else:
                t = take.view((L * N,) + (1,) * (a.dim() - 1))
                children[f] = torch.where(t, b, a)
        nl, bounds = var
        for _ in range(cfg.mutations):
            children = mutate(gen, children, self.space, cfg.fields, nl=nl,
                              bounds=bounds)
        return children

    def immigrants(self, gen, var_imm):
        if not self.n_imm:
            return None
        nl, bounds = var_imm
        return random_design(gen, self.space, self.lanes * self.n_imm,
                             nl=nl, bounds=bounds, device=self.dev)

    def with_immigrants(self, children: Dict, imm: Optional[Dict]) -> Dict:
        """Random immigrants replace the first ``n_imm`` children of every
        lane (they fight convergence collapse of the front)."""
        if imm is None:
            return children
        L, n = self.lanes, self.n_imm
        return {k: torch.cat([imm[k].view(L, n, *v.shape[1:]),
                              v.view(L, -1, *v.shape[1:])[:, n:]],
                             1).reshape(v.shape)
                for k, v in children.items()}

    # ---- evaluation and selection -------------------------------------------
    def evaluate(self, pop: Dict, arr: Dict, lanes: int):
        m = evaluate_arrays(arr, pop, self.dims, self.tech, lanes=lanes)
        raw = metric_stack(m)
        p = feasibility_penalty(self.space, pop, m)
        sel = log_metric_stack(m)[:, self.obj_idx] + 8.0 * torch.log(p)[:, None]
        return raw, sel, p <= 1.0 + 1e-6       # feasible <=> no penalty

    def select(self, pop, raw, sel, feas, cand, craw, csel, cfeas):
        """Environmental selection of every lane over its parents + its
        candidates: ascending rank, fewer dominators first, crowding
        breaking ties, non-finite rows last.  Returns the next (L x N)
        population, raw, sel and feasibility."""
        L, N = self.lanes, self.cfg.pop

        def pool(a, b):                           # (L, N + n_cand, ...)
            return torch.cat([a.view(L, -1, *a.shape[1:]),
                              b.view(L, -1, *b.shape[1:])], 1)
        a_sel = pool(sel, csel)
        finite = torch.isfinite(a_sel).all(-1)
        a_sane = torch.where(torch.isfinite(a_sel), a_sel, BIG)
        nd = dominance_counts(a_sane, finite)
        crowd = crowding_distance(a_sane, finite)
        keyv = torch.where(finite,
                           nd.to(F) * 1e6 - crowd.clamp(max=1e5), BIG)
        order = torch.argsort(keyv, dim=-1, stable=True)[:, :N]
        lane = torch.arange(L, device=self.dev)[:, None]

        def take(a, b):
            x = pool(a, b)[lane, order]
            return x.reshape(L * N, *x.shape[2:])
        pop_n = {k: take(pop[k], cand[k]) for k in pop}
        return (pop_n, take(raw, craw), take(sel, csel),
                take(feas, cfeas))

    def telemetry(self, sel_n, feas_n, cfeas, hv_run, best_run):
        """Per-generation convergence stats of every lane's selected
        population — dominance/staircase math only, no evaluations."""
        L = self.lanes
        sel_n = sel_n.view(L, -1, sel_n.shape[-1])
        feas_n = feas_n.view(L, -1)
        finite = torch.isfinite(sel_n).all(-1)
        ok = finite & feas_n
        sane = torch.where(torch.isfinite(sel_n), sel_n, BIG)
        nd = dominance_counts(sane, ok)
        front_size = ((nd == 0) & ok).sum(-1).to(torch.int32)
        hv_now = hv_run
        if self.pairs:
            hv_ref = (HV_LOG_REF, HV_LOG_REF)
            hv_now = torch.stack([
                hypervolume_2d_jit(sel_n[..., [i, j]], hv_ref, valid=ok)
                for i, j in self.pairs], -1)
            hv_run = torch.maximum(hv_run, hv_now)
        scal = torch.where(finite, sane.sum(-1), BIG)
        best_run = torch.minimum(best_run, scal.amin(-1))
        tr = dict(front_size=front_size, hypervolume=hv_run, hv_now=hv_now,
                  best=best_run,
                  feasible_frac=cfeas.view(L, -1).to(F).mean(-1))
        return hv_run, best_run, tr

    def start(self, pops: Dict):
        """The loop's carry, from ``pops`` (L, N, ...): the initial
        population carries +inf
        objectives, so its (variated) offspring are evaluated in generation
        0 and unevaluated parents rank last."""
        L, N, dev = self.lanes, self.cfg.pop, self.dev
        return ({k: torch.as_tensor(v).to(device=dev, dtype=torch.int32)
                 .reshape(L * N, *v.shape[2:]) for k, v in pops.items()},
                torch.full((L * N, len(METRIC_KEYS)), torch.inf, device=dev),
                torch.full((L * N, len(self.idx)), torch.inf, device=dev),
                torch.zeros(L * N, dtype=torch.bool, device=dev),
                torch.zeros(L, len(self.pairs), dtype=F, device=dev),
                torch.full((L,), torch.inf, dtype=F, device=dev))

    def stack(self, outs, carry):
        """Per-generation outputs stacked as the reference's scan outputs,
        with a leading lane axis: (pop, raw, sel, ev_designs, ev_raw,
        ev_feas, trace)."""
        L = self.lanes

        def lanes_first(x):                      # (L x n, ...) -> (L, n, ...)
            return x.view(L, -1, *x.shape[1:])

        def over_gens(xs):                       # -> (L, G, n, ...)
            return torch.stack([lanes_first(x) for x in xs], 1)
        pop, raw, sel = carry[:3]
        ev_designs = {k: over_gens([o[0][k] for o in outs])
                      for k in outs[0][0]}
        ev_raw = over_gens([o[1] for o in outs])
        ev_feas = over_gens([o[2] for o in outs])
        trace = {k: torch.stack([o[3][k] for o in outs], 1)
                 for k in outs[0][3]}
        return ({k: lanes_first(v) for k, v in pop.items()},
                lanes_first(raw), lanes_first(sel), ev_designs, ev_raw,
                ev_feas, trace)

    def run(self, gen, pops: Dict, arrays_seq: Sequence, gate=None):
        """The generations.  ``gate`` (one lane only) maps the children to
        (the slots to evaluate, forced count, mean disagreement): only
        those are evaluated and compete in the selection."""
        arr, var, var_imm = self.problem(arrays_seq)
        carry = self.start(pops)
        outs = []
        for _ in range(self.cfg.generations):
            imm = self.immigrants(gen, var_imm)
            pop, raw, sel, feas, hv_run, best_run = carry
            cand = self.with_immigrants(self.variate(gen, pop, var), imm)
            if gate is not None:
                order, n_forced, dis = gate(cand)
                cand = {k: v[order] for k, v in cand.items()}
            craw, csel, cfeas = self.evaluate(cand, arr, self.lanes)
            pop_n, raw_n, sel_n, feas_n = self.select(
                pop, raw, sel, feas, cand, craw, csel, cfeas)
            hv_run, best_run, tr = self.telemetry(sel_n, feas_n, cfeas,
                                                  hv_run, best_run)
            if gate is not None:
                tr.update(forced_exact=n_forced[None],
                          disagreement=dis[None])
            carry = (pop_n, raw_n, sel_n, feas_n, hv_run, best_run)
            outs.append((cand, craw, cfeas, tr))
        return self.stack(outs, carry)


def _unlane(out):
    """A one-lane runner's outputs without the lane axis."""
    pop, raw, sel, ev_designs, ev_raw, ev_feas, trace = out
    return ({k: v[0] for k, v in pop.items()}, raw[0], sel[0],
            {k: v[0] for k, v in ev_designs.items()}, ev_raw[0], ev_feas[0],
            {k: v[0] for k, v in trace.items()})


def make_nsga(spec: SystemSpec, space: DesignSpace,
              objectives: Tuple[str, ...] = METRIC_KEYS,
              cfg: NSGAConfig = NSGAConfig(), tech=None, device="cuda"):
    """Build a front explorer on ``device``.

    Returns ``run(seed, pop0, arrays=None) ->
    (pop, raw, sel, ev_designs, ev_raw, ev_feas, trace)`` where ``pop0`` is
    a design dict of width ``cfg.pop`` on the device; ``raw`` is the
    (pop, 4) matrix of raw metrics in ``METRIC_KEYS`` order and ``sel`` the
    (pop, n_obj) penalized log-objectives selection ranked on.
    ``ev_designs`` / ``ev_raw`` / ``ev_feas`` are EVERY evaluated design of
    the run, stacked (generations, pop, ...) — the archive fodder.
    ``ev_feas`` marks designs with no feasibility penalty.  ``trace`` is a
    dict of stacked per-generation tensors (``front_size``,
    ``hypervolume``, ``hv_now``, ``best``, ``feasible_frac``) — feed it to
    ``ConvergenceTrace.from_scan``.  ``seed`` is an integer; the run draws
    from one ``torch.Generator`` on the device seeded with it.
    """
    eng = _Engine(spec, space, objectives, cfg, tech, device)
    state = _run_state("nsga", spec, space, objectives, cfg, tech, eng.dev)

    def run(seed: int, pop0: Dict, arrays=None):
        out = _unlane(eng.run(generator(seed, eng.dev),
                              {k: v[None] for k, v in pop0.items()},
                              [arrays]))
        state["executed"] = True
        return out

    # ``compile_state["executed"]`` is False until a runner of this variant
    # has run in this process (the reference's first-call attribution)
    run.compile_state = state
    return run


def make_nsga_fused(spec: SystemSpec, space: DesignSpace,
                    objectives: Tuple[str, ...] = METRIC_KEYS,
                    cfg: NSGAConfig = NSGAConfig(), tech=None,
                    lanes: int = 1, device="cuda"):
    """Build a MULTI-PROBLEM front explorer: ``lanes`` populations —
    typically different problems whose spec arrays share one padded shape
    (``spec``/``space`` fix the shape and the space's bounds) — evolve in
    one loop.

    Returns ``run(seeds, pops, arrays_seq)``: ``seeds`` are ``lanes``
    integer seeds, ``pops`` a design dict of (lanes, cfg.pop, ...) tensors
    and ``arrays_seq`` ``lanes`` spec-array dicts of equal shapes (``None``
    for ``spec``'s own).  Outputs match ``make_nsga``'s with a leading lane
    axis.  Lane ``i`` draws from its own generator seeded with
    ``seeds[i]``, in ``make_nsga``'s order, so it evolves the same designs
    as ``make_nsga(...)(seeds[i], pops[i], arrays=arrays_seq[i])``;
    evaluation, selection (one ``pareto_rank`` launch for every lane's
    pool), crowding, sorts and telemetry run once for all lanes.  Callers
    pow2-pad the lane count (``quantize.bucket_lanes``) and discard the
    padding lanes' outputs, as the reference's service does."""
    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    eng = _Engine(spec, space, objectives, cfg, tech, device, lanes=lanes)
    state = _run_state("fused", spec, space, objectives, cfg, tech, eng.dev,
                       lanes)

    def run(seeds: Sequence[int], pops: Dict, arrays_seq: Sequence):
        if len(seeds) != lanes or len(arrays_seq) != lanes:
            raise ValueError(f"expected {lanes} seeds/array dicts")
        gens = [generator(s, eng.dev) for s in seeds]
        out = eng.run(gens[0] if lanes == 1 else LaneGenerators(gens),
                      pops, list(arrays_seq))
        state["executed"] = True
        return out

    run.compile_state = state
    return run


def gate_candidates(sur: Dict, X: torch.Tensor, obj_idx: torch.Tensor,
                    n_exact: int, beta: float, tau: float):
    """Pick the ``n_exact`` exact-evaluation slots among N candidates
    encoded as ``X`` (N, design encoding): forced-by-disagreement first,
    then predicted-Pareto optimists (dominance counts of the ensemble's
    lower-confidence-bound objectives, mean - ``beta`` x std in normalized
    output space, crowding breaking ties).  ``sur`` is
    ``Surrogate.scan_arrays``.  Returns (slots (n_exact,), forced count,
    mean disagreement)."""
    N = X.shape[0]
    X = torch.cat([X, sur["emb"].expand(N, -1)], 1)
    out = ensemble_forward(sur, (X - sur["x_mean"]) / sur["x_std"])
    mean_n = out.mean(0)
    std_n = out.std(0, correction=0)
    dis = std_n.mean(1)                                   # (N,)
    lcb = (mean_n - beta * std_n)[:, obj_idx]
    ones = torch.ones(N, dtype=torch.bool, device=X.device)
    nd = dominance_counts(lcb, ones)
    crowd = crowding_distance(lcb, ones)
    score = nd.to(F) * 1e6 - crowd.clamp(max=1e5)
    forced = dis > tau
    score = torch.where(forced, -BIG, score)
    order = torch.argsort(score, stable=True)[:n_exact]
    return order, forced.sum().to(torch.int32), dis.mean()


def make_nsga_gated(spec: SystemSpec, space: DesignSpace,
                    objectives: Tuple[str, ...] = METRIC_KEYS,
                    cfg: NSGAConfig = NSGAConfig(), tech=None,
                    n_exact: int = 1, beta: float = 1.0, tau: float = 1.0,
                    device="cuda"):
    """Build a SURROGATE-GATED front explorer: each generation makes the
    same ``cfg.pop`` candidate children as ``make_nsga`` (the same draws in
    the same order), but only the ``n_exact`` slots ``gate_candidates``
    picks are evaluated exactly; selection runs over the pop + n_exact
    pool.  Candidates whose normalized ensemble disagreement exceeds
    ``tau`` are FORCED into the exact slots whatever their rank.

    Returns ``run(seed, pop0, sur, arrays=None)`` shaped like the
    ``make_nsga`` runner except ``ev_designs`` / ``ev_raw`` / ``ev_feas``
    stack (generations, n_exact, ...) — only exact evaluations are archive
    fodder — and ``trace`` gains ``forced_exact`` (G,) and
    ``disagreement`` (G,).  ``sur`` is ``Surrogate.scan_arrays(embedding)``
    on the device."""
    eng = _Engine(spec, space, objectives, cfg, tech, device)
    n_exact = min(max(int(n_exact), 1), cfg.pop)
    state = _run_state("gated", spec, space, objectives, cfg, tech, eng.dev,
                       n_exact, float(beta), float(tau))

    def run(seed: int, pop0: Dict, sur: Dict, arrays=None):
        def gate(children):             # exact-evaluate the chosen slots
            return gate_candidates(sur, flatten_rows(children), eng.obj_idx,
                                   n_exact, float(beta), float(tau))
        out = _unlane(eng.run(generator(seed, eng.dev),
                              {k: v[None] for k, v in pop0.items()},
                              [arrays], gate=gate))
        state["executed"] = True
        return out

    run.n_exact = n_exact
    run.compile_state = state
    return run
