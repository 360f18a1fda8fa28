"""Uniform encoding of the architecture + integration design space
(paper Sec. IV-B, Fig. 6a) — the search half of ``repro.core.encoding``.

Architecture fields (per workload):
    shape   (W, 6)   geometry of PE / core / chiplet arrays (raw dims)
    spatial (W, 6)   spatially-parallelized loop per array dim per level
    order   (W, 3, L) loop permutation per level (execution order)
    tiling  (W, 2, L) tile sizes (core tile t1, chiplet tile t2)
    pipe    (W,)     pipelined loop id (== L means "not pipelined")
    logB    ()       log2 of pipeline tick count

Integration fields:
    packaging ()       0 organic / 1 passive / 2 active interposer
    family    ()       network topology family (chain/ring/mesh/star)
    placement (W*CH,)  global chiplet id -> network node id (a permutation)

Every function here works on populations: each field carries a leading
dimension P.  Per-row permutations are the ``argsort`` of uniform draws;
``mutate`` computes every move of ``fields`` for every design and keeps one
per design by mask, where the reference dispatches with ``lax.switch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime import generator, resolve_device
from .evaluate import SystemSpec
from .network import MAX_NODES, N_FAMILIES
from .workload import MAX_LOOPS

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Static bounds of the explorable space for one SystemSpec."""
    spec: SystemSpec
    max_shape: Tuple[int, ...] = (16, 16, 4, 4, 6, 6)   # per-level max dims
    max_logB: int = 6
    max_total_pes: int = 0          # 0 = unconstrained (Fig-7 fairness knob)
    fixed_packaging: int = -1       # >=0 pins the field (ablation studies)
    fixed_family: int = -1
    allow_pipeline: bool = True

    @property
    def W(self):
        return self.spec.W

    @property
    def CH(self):
        return self.spec.CH

    @property
    def n_loops(self) -> np.ndarray:
        return self.spec.arrays["loopmask"].sum(axis=1).astype(np.int32)

    @property
    def bounds(self) -> np.ndarray:
        return self.spec.arrays["bounds"]

    def max_nodes(self) -> int:
        return min(MAX_NODES, self.W * self.CH)


def _randint(gen, shape, low, high, device):
    """Uniform integers in [low, high); ``high`` may be a tensor that
    broadcasts against ``shape`` (per-element upper bounds)."""
    u = torch.rand(shape, generator=gen, device=device)
    v = low + torch.floor(u * (high - low)).to(torch.int64)
    return torch.minimum(v, torch.as_tensor(high, device=device) - 1).to(I32)


def _rand_perm_rows(gen, shape, device):
    """Independent uniform permutations of the last axis of ``shape``."""
    return torch.argsort(torch.rand(shape, generator=gen, device=device),
                         dim=-1).to(I32)


def random_design(key, space: DesignSpace, n: Optional[int] = None,
                  nl=None, bounds=None, device="cuda") -> Dict:
    """Uniform random design points (the paper's 'Random' baseline): a
    population of ``n`` designs (fields with a leading dim n), or one
    design without the leading dim when ``n`` is None.

    ``key`` is an integer seed or a ``torch.Generator`` on ``device``;
    ``nl``/``bounds`` may be passed as tensors (the workload's loop counts
    and bounds), as in the reference."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else generator(key, dev)
    m = 1 if n is None else int(n)
    W, CH, L = space.W, space.CH, MAX_LOOPS
    mx = torch.as_tensor(space.max_shape, device=dev)
    shape = _randint(gen, (m, W, 6), 1, mx + 1, dev)
    nl = torch.as_tensor(space.n_loops if nl is None else nl,
                         device=dev).long()
    nl1 = nl.clamp_min(1)
    spatial = _randint(gen, (m, W, 6), 0, nl1[:, None], dev)
    order = _rand_perm_rows(gen, (m, W, 3, L), dev)
    bounds = torch.as_tensor(space.bounds if bounds is None else bounds,
                             device=dev)
    tmax = bounds.clamp_min(1).to(torch.float32)
    u = torch.rand((m, W, 2, L), generator=gen, device=dev)
    tiling = (tmax[:, None, :] ** u).clamp_min(1.0).to(I32)
    on = torch.rand((m, W), generator=gen, device=dev) < 0.5
    pipe_loop = _randint(gen, (m, W), 0, nl1, dev)
    pipe = torch.where(on & space.allow_pipeline, pipe_loop,
                       torch.full_like(pipe_loop, L))
    logB = (_randint(gen, (m,), 0, space.max_logB + 1, dev)
            if space.allow_pipeline else torch.zeros(m, dtype=I32, device=dev))
    packaging = (torch.full((m,), space.fixed_packaging, dtype=I32, device=dev)
                 if space.fixed_packaging >= 0
                 else _randint(gen, (m,), 0, 3, dev))
    family = (torch.full((m,), space.fixed_family, dtype=I32, device=dev)
              if space.fixed_family >= 0
              else _randint(gen, (m,), 0, N_FAMILIES, dev))
    placement = _rand_perm_rows(gen, (m, W * CH), dev)
    d = dict(shape=shape, spatial=spatial, order=order, tiling=tiling,
             pipe=pipe, logB=logB, packaging=packaging, family=family,
             placement=placement)
    return d if n is not None else {k: v[0] for k, v in d.items()}


# ---------------------------------------------------------------------------
# SA neighborhood moves (one random field mutation per design per call)
# ---------------------------------------------------------------------------
ARCH_FIELDS = ("shape", "spatial", "order", "tiling", "pipe")
INTEG_FIELDS = ("packaging", "family", "placement")
ALL_FIELDS = ARCH_FIELDS + INTEG_FIELDS
# high-dimensional fields owned by the SA engine (paper Sec. IV-C)
SA_FIELDS = ("order", "tiling", "pipe", "placement")
# low-dimensional fields owned by the Bayesian engine
BO_FIELDS = ("shape", "spatial", "packaging", "family")


def mutate(gen: torch.Generator, design: Dict, space: DesignSpace,
           fields: Tuple[str, ...] = ALL_FIELDS,
           nl=None, bounds=None) -> Dict:
    """One random neighbor move per design, restricted to ``fields``.

    ``design`` is a population (fields with a leading dim P) on the
    generator's device.  Each design draws its workload and its move; every
    move of ``fields`` is computed for the whole population and each design
    keeps the one it drew."""
    dev = design["shape"].device
    P = design["shape"].shape[0]
    W, CH, L = space.W, space.CH, MAX_LOOPS
    nl = torch.as_tensor(space.n_loops if nl is None else nl,
                         device=dev).long().clamp_min(1)
    bounds_arr = torch.as_tensor(space.bounds if bounds is None else bounds,
                                 device=dev).long()
    ar = torch.arange(P, device=dev)
    wsel = _randint(gen, (P,), 0, W, dev).long()
    mid = _randint(gen, (P,), 0, len(fields), dev)
    nl_w = nl[wsel]

    def pick(values):
        idx = _randint(gen, (P,), 0, len(values), dev).long()
        return torch.as_tensor(values, device=dev)[idx]

    # --- architecture moves -------------------------------------------------
    def mv_shape():
        i = _randint(gen, (P,), 0, 6, dev).long()
        delta = pick([-2, -1, 1, 2]).to(I32)
        s = design["shape"].clone()
        s[ar, wsel, i] += delta
        mx = torch.as_tensor(space.max_shape, dtype=I32, device=dev)
        return dict(shape=torch.minimum(s.clamp_min(1), mx))

    def mv_spatial():
        i = _randint(gen, (P,), 0, 6, dev).long()
        v = _randint(gen, (P,), 0, nl_w, dev)
        s = design["spatial"].clone()
        s[ar, wsel, i] = v
        return dict(spatial=s)

    def mv_order():
        lvl = _randint(gen, (P,), 0, 3, dev).long()
        i = _randint(gen, (P,), 0, L, dev).long()
        j = _randint(gen, (P,), 0, L, dev).long()
        o = design["order"].clone()
        a, b = o[ar, wsel, lvl, i], o[ar, wsel, lvl, j]
        o[ar, wsel, lvl, i] = b
        o[ar, wsel, lvl, j] = a
        return dict(order=o)

    def mv_tiling():
        lvl = _randint(gen, (P,), 0, 2, dev).long()
        i = _randint(gen, (P,), 0, nl_w, dev).long()
        f = pick([0.25, 0.5, 2.0, 4.0])
        bmax = bounds_arr[wsel, i].to(I32)
        t = design["tiling"][ar, wsel, lvl, i].to(torch.float32) * f
        t = torch.minimum(t.to(I32).clamp_min(1), bmax)
        tl = design["tiling"].clone()
        tl[ar, wsel, lvl, i] = t.clamp_min(1)
        return dict(tiling=tl)

    def mv_pipe():
        on = torch.rand((P,), generator=gen, device=dev) < (
            0.7 if space.allow_pipeline else 0.0)
        loop = _randint(gen, (P,), 0, nl_w, dev)
        step = _randint(gen, (P,), -1, 2, dev)
        pp = design["pipe"].clone()
        pp[ar, wsel] = torch.where(on, loop, L).to(I32)
        logB = torch.where(
            on, (design["logB"] + step).clamp(0, space.max_logB),
            design["logB"]).to(I32)
        return dict(pipe=pp, logB=logB)

    # --- integration moves ---------------------------------------------------
    def mv_packaging():
        if space.fixed_packaging >= 0:
            return {}
        return dict(packaging=_randint(gen, (P,), 0, 3, dev))

    def mv_family():
        if space.fixed_family >= 0:
            return {}
        return dict(family=_randint(gen, (P,), 0, N_FAMILIES, dev))

    def mv_placement():
        i = _randint(gen, (P,), 0, W * CH, dev).long()
        j = _randint(gen, (P,), 0, W * CH, dev).long()
        p = design["placement"].clone()
        a, b = p[ar, i], p[ar, j]
        p[ar, i] = b
        p[ar, j] = a
        return dict(placement=p)

    all_moves = dict(shape=mv_shape, spatial=mv_spatial, order=mv_order,
                     tiling=mv_tiling, pipe=mv_pipe, packaging=mv_packaging,
                     family=mv_family, placement=mv_placement)
    out = dict(design)
    for mi, f in enumerate(fields):
        sel = mid == mi
        for k, v in all_moves[f]().items():
            out[k] = torch.where(sel.view((P,) + (1,) * (v.dim() - 1)), v,
                                 out[k])
    return out


def feasibility_penalty(space: DesignSpace, design: Dict, metrics=None):
    """Soft constraints: total chiplets <= placeable nodes; optional PE
    budget (Fig. 7 iso-PE comparisons).  A (P,) multiplicative penalty."""
    s = design["shape"].long()
    n_chips = (s[..., 4] * s[..., 5]).sum(-1)
    over_nodes = (n_chips - space.max_nodes()).clamp_min(0).to(torch.float32)
    pes = s.prod(-1).sum(-1)
    if space.max_total_pes > 0:
        over_pes = (pes - space.max_total_pes).clamp_min(0).to(torch.float32)
    else:
        over_pes = torch.zeros_like(over_nodes)
    return 1.0 + over_nodes + over_pes / 64.0
