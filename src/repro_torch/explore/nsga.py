"""NSGA-II-style evolutionary front explorer — the port of
``repro.explore.nsga.make_nsga`` (single device, no islands).

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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..core.constants import DEFAULT_TECH
from ..core.encoding import (ALL_FIELDS, DesignSpace, feasibility_penalty,
                             mutate, random_design)
from ..core.evaluate import SystemSpec, evaluate_arrays, spec_tensors
from ..core.optimizer import METRIC_KEYS, log_metric_stack, metric_stack
from ..runtime import generator, resolve_device
from .archive import (BIG, HV_LOG_REF, crowding_distance, dominance_counts,
                      hypervolume_2d_jit, objective_pairs)

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


def pmx(gen: torch.Generator, a: torch.Tensor, b: torch.Tensor):
    """Partially-mapped crossover of two batches of permutations (P, n).

    A random segment ``[lo, hi)`` of ``b`` is worked into a child that
    otherwise inherits ``a``: walking the segment, ``b[k]`` is swapped into
    position ``k`` (the classic in-place PMX formulation), so each result
    row is a valid permutation carrying ``b``'s segment and ``a``'s relative
    order elsewhere."""
    P, n = a.shape
    dev = a.device
    i = torch.floor(torch.rand(P, generator=gen, device=dev) * n).long()
    j = torch.floor(torch.rand(P, generator=gen, device=dev) * (n + 1)).long()
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
    tech = tech or DEFAULT_TECH
    dev = resolve_device(device)
    dims = (spec.W, spec.CH, spec.E)
    idx = tuple(METRIC_KEYS.index(o) for o in objectives)
    if not idx:
        raise ValueError("objectives must name at least one metric")
    N = cfg.pop
    obj_idx = torch.as_tensor(idx, device=dev)
    pairs = objective_pairs(len(idx))
    hv_ref = (HV_LOG_REF, HV_LOG_REF)
    n_imm = int(round(N * cfg.immigrants))
    spec_arr = spec_tensors(spec.arrays, dev)

    def eval_pop(pop, arr):
        m = evaluate_arrays(arr, pop, dims, tech)
        raw = metric_stack(m)
        p = feasibility_penalty(space, pop, m)
        sel = log_metric_stack(m)[:, obj_idx] + 8.0 * torch.log(p)[:, None]
        return raw, sel, p <= 1.0 + 1e-6       # feasible <=> no penalty

    def crossover(gen, a, b):
        out = {}
        for f in _DESIGN_KEYS:
            take = torch.rand(N, generator=gen, device=dev) < cfg.crossover_rate
            if f == "placement" and cfg.pmx_placement:
                # PMX keeps the child a valid permutation while mixing both
                # parents' placements (a whole-field take copies one)
                mixed = pmx(gen, a[f], b[f])
                out[f] = torch.where(take[:, None], mixed, a[f])
            else:
                t = take.view((N,) + (1,) * (a[f].dim() - 1))
                out[f] = torch.where(t, b[f], a[f])
        return out

    def telemetry(sel_n, feas_n, cfeas, hv_run, best_run):
        """Per-generation convergence stats over the selected population —
        dominance/staircase math only, no design evaluations."""
        finite = torch.isfinite(sel_n).all(-1)
        ok = finite & feas_n
        sane = torch.where(torch.isfinite(sel_n), sel_n, BIG)
        nd = dominance_counts(sane, ok)
        front_size = ((nd == 0) & ok).sum().to(torch.int32)
        hv_now = hv_run
        if pairs:
            hv_now = torch.stack([
                hypervolume_2d_jit(sel_n[:, [i, j]], hv_ref, valid=ok)
                for i, j in pairs])
            hv_run = torch.maximum(hv_run, hv_now)
        scal = torch.where(finite, sane.sum(-1), BIG)
        best_run = torch.minimum(best_run, scal.min())
        tr = dict(front_size=front_size, hypervolume=hv_run, hv_now=hv_now,
                  best=best_run, feasible_frac=cfeas.to(F).mean())
        return hv_run, best_run, tr

    def step(gen, arr, nl, carry, imm_g):
        pop, raw, sel, feas, hv_run, best_run = carry
        # --- variation: whole-field crossover with a random mate, then a
        # few chained single-field mutate moves (the SA neighborhood)
        partners = torch.randint(0, N, (N,), generator=gen, device=dev)
        mates = {k: v[partners] for k, v in pop.items()}
        children = crossover(gen, pop, mates)
        for _ in range(cfg.mutations):
            children = mutate(gen, children, space, cfg.fields, nl=nl,
                              bounds=arr["bounds"])
        if n_imm:
            # random immigrants fight convergence collapse of the front
            children = {k: torch.cat([imm_g[k], v[n_imm:]])
                        for k, v in children.items()}
        craw, csel, cfeas = eval_pop(children, arr)

        # --- environmental selection over the 2N parent+child pool
        a_pop = {k: torch.cat([pop[k], children[k]]) for k in pop}
        a_raw = torch.cat([raw, craw])
        a_sel = torch.cat([sel, csel])
        a_feas = torch.cat([feas, cfeas])
        finite = torch.isfinite(a_sel).all(-1)
        a_sane = torch.where(torch.isfinite(a_sel), a_sel, BIG)
        nd = dominance_counts(a_sane, finite)
        crowd = crowding_distance(a_sane, finite)
        # ascending rank: fewer dominators first, crowding breaks ties;
        # non-finite rows sort last
        keyv = torch.where(finite,
                           nd.to(F) * 1e6 - crowd.clamp(max=1e5), BIG)
        order = torch.argsort(keyv, stable=True)[:N]
        pop_n = {k: v[order] for k, v in a_pop.items()}
        raw_n, sel_n, feas_n = a_raw[order], a_sel[order], a_feas[order]
        hv_run, best_run, tr = telemetry(sel_n, feas_n, cfeas,
                                         hv_run, best_run)
        return ((pop_n, raw_n, sel_n, feas_n, hv_run, best_run),
                (children, craw, cfeas, tr))

    def run(seed: int, pop0: Dict, arrays=None):
        arr = spec_arr if arrays is None else spec_tensors(arrays, dev)
        nl = arr["loopmask"].sum(1).to(torch.int32)
        gen = generator(seed, dev)
        # the initial population carries +inf objectives: its (variated)
        # offspring are evaluated in generation 0 and unevaluated parents
        # rank last
        carry = ({k: v.to(device=dev, dtype=torch.int32)
                  for k, v in pop0.items()},
                 torch.full((N, len(METRIC_KEYS)), torch.inf, device=dev),
                 torch.full((N, len(idx)), torch.inf, device=dev),
                 torch.zeros(N, dtype=torch.bool, device=dev),
                 torch.zeros(len(pairs), dtype=F, device=dev),
                 torch.tensor(torch.inf, dtype=F, device=dev))
        outs = []
        for _ in range(cfg.generations):
            imm = (random_design(gen, space, n_imm, nl=nl,
                                 bounds=arr["bounds"], device=dev)
                   if n_imm else None)
            carry, out = step(gen, arr, nl, carry, imm)
            outs.append(out)
        pop, raw, sel = carry[:3]
        ev_designs = {k: torch.stack([o[0][k] for o in outs])
                      for k in outs[0][0]}
        ev_raw = torch.stack([o[1] for o in outs])
        ev_feas = torch.stack([o[2] for o in outs])
        trace = {k: torch.stack([o[3][k] for o in outs])
                 for k in outs[0][3]}
        return pop, raw, sel, ev_designs, ev_raw, ev_feas, trace

    return run
