"""Per-chiplet dataflow analysis (paper Sec. III-B/III-C, TENET-style).

The port of ``repro.core.dataflow``: the same arithmetic, written over
tensors with explicit leading batch dimensions (the population P and the
workload W) instead of ``vmap``.  Given workload arrays and chiplet design
fields it computes trip counts and spatial splits per hierarchy level,
buffer footprints, order-dependent access counts with multicast discounts,
compute cycles and the pipelined per-level delay
``D = trips x max(D_C, D_B, D_A)`` (Sec. III-C).

Hierarchy and loop structure modeled per chiplet (paper Fig. 1):

    for n2-loops over t2-tiles          # chiplet buffer refilled from ext
      spatial over (X1 x Y1) cores
      for n1-loops over t1-tiles        # core buffer refilled from chiplet buf
        spatial over (X0 x Y0) PEs
        for p-loops over elements       # PE: 1 MAC/cycle, register reuse

Design-point fields (int32), each with leading batch dims ``...``:
    shape   (..., 6)     [x0, y0, x1, y1, x2, y2] raw array dims (>= 1)
    spatial (..., 6)     [sx0, sy0, sx1, sy1, sx2, sy2] loop ids per level
    order   (..., 3, L)  loop id by position, 0 = outermost (PE, core, chiplet)
    tiling  (..., 2, L)  [t1; t2] raw tile sizes (clamped internally)

Products are taken in float32, as in the reference.  Tech constants may be
Python numbers or 0-d tensors (autograd reaches them).
"""

from __future__ import annotations

from typing import Dict

import torch

from .constants import DEFAULT_TECH, TechConstants
from .workload import MAX_LOOPS

F = torch.float32


def _cdiv(a, b):
    return (a + b - 1) // b


def _clamp_min(v, lo: float):
    """max(v, lo) for a Python number or a tensor."""
    return v.clamp_min(lo) if torch.is_tensor(v) else max(v, lo)


def _split_of(spatial_x, spatial_y, X, Y, L=MAX_LOOPS):
    """Per-loop spatial split factor at one level: (...,) -> (..., L)."""
    l = torch.arange(L, device=X.device)
    sx = torch.where(l == spatial_x[..., None], X[..., None], 1)
    sy = torch.where(l == spatial_y[..., None], Y[..., None], 1)
    return sx * sy                       # if sx==sy loop: X*Y on that loop


def _positions(order):
    """order: (..., L) loop id by position -> pos[loop] (0 = outermost)."""
    return torch.argsort(order, dim=-1, stable=True)


def _footprint(A, dmask, tile):
    """Tile footprint (elements) per tensor.  A: (..., T, D, L) int,
    tile: (..., L) -> (..., T)."""
    span = (A.to(F) * tile[..., None, None, :].to(F)).sum(-1)   # (..., T, D)
    nnz = (A != 0).sum(-1).to(F)
    fd = torch.where(dmask, span - (nnz - 1.0).clamp_min(0.0), 1.0)
    return fd.clamp_min(1.0).prod(-1)


def _refills(rel, pos, trips, loopmask):
    """Order-aware refill count per tensor.

    rel: (..., T, L) bool — loop relevant to tensor; pos: (..., L) position
    of each loop; trips: (..., L) trip counts at this level.  A tensor tile
    is reused across the innermost contiguous run of irrelevant loops;
    every loop at or outside the innermost *relevant* position multiplies
    refills."""
    posb = pos[..., None, :]                                  # (..., 1, L)
    lm = loopmask[..., None, :]
    pstar = torch.where(rel & lm, posb, -1).amax(-1)          # (..., T)
    count = (posb <= pstar[..., None]) & lm
    return torch.where(count, trips[..., None, :].to(F), 1.0).prod(-1)


def _distinct(rel, trips, loopmask):
    return torch.where(rel & loopmask[..., None, :],
                       trips[..., None, :].to(F), 1.0).prod(-1)


def _multicast(rel, spatial_x, spatial_y, X, Y):
    """Multicast fan-out for tensors *not* split by a spatial loop.
    rel: (..., T, L); spatial/X/Y: (...,) -> (..., T)."""
    T, L = rel.shape[-2:]
    relb = torch.broadcast_to(rel, spatial_x.shape + (T, L))

    def pick(s):                         # rel[:, s] with the index clamped
        idx = s.long().clamp(0, L - 1)[..., None, None].expand(
            *s.shape, T, 1)
        return relb.gather(-1, idx)[..., 0]

    mx = torch.where(pick(spatial_x), 1, X[..., None])
    my = torch.where(pick(spatial_y), 1, Y[..., None])
    same = (spatial_x == spatial_y)[..., None]
    return torch.where(same, mx, mx * my).to(F)


def analyze_chiplet(wl: Dict, shape, spatial, order, tiling,
                    tech: TechConstants = DEFAULT_TECH,
                    ext_bw_gbps=None) -> Dict:
    """Analyze workloads mapped on chiplet designs, batched.

    wl: dict of workload tensors (bounds/loopmask/A/tmask/dmask/is_out)
      whose leading dims broadcast against the design's batch dims.
    ext_bw_gbps: effective external (network/DRAM) bandwidth per design
      (a tensor of the batch shape); defaults to the DRAM bandwidth.  The
      system evaluator re-invokes with contention-derived bandwidth.
    Returns a dict of float32 tensors of the batch shape (``ext_*_t`` and
    ``ext_multicast_t`` carry a trailing tensor axis T).
    """
    bounds = wl["bounds"].to(torch.int32)
    loopmask = wl["loopmask"]
    A, tmask, dmask, is_out = wl["A"], wl["tmask"], wl["dmask"], wl["is_out"]
    rel = (A != 0).any(dim=-2) & tmask[..., None]             # (..., T, L)
    tm = tmask.to(F)

    x0, y0, x1, y1, x2, y2 = [shape[..., i].clamp_min(1) for i in range(6)]
    n_pe, n_core, n_chip = x0 * y0, x1 * y1, x2 * y2
    n_pe_f, n_core_f = n_pe.to(F), n_core.to(F)

    ext_bw = tech.dram_bw if ext_bw_gbps is None else ext_bw_gbps
    bpe = float(tech.bytes_per_elem)

    # ---- per-loop tiling / trip structure ---------------------------------
    s2 = _split_of(spatial[..., 4], spatial[..., 5], x2, y2)  # cluster split
    N2 = _cdiv(bounds, s2)                                    # per-chiplet
    t2 = torch.minimum(tiling[..., 1, :].clamp_min(1), N2)
    n2 = torch.where(loopmask, _cdiv(N2, t2), 1)              # chiplet trips

    s1 = _split_of(spatial[..., 2], spatial[..., 3], x1, y1)
    share1 = _cdiv(t2, s1)                                    # per-core share
    t1 = torch.minimum(tiling[..., 0, :].clamp_min(1), share1)
    n1 = torch.where(loopmask, _cdiv(share1, t1), 1)          # core trips

    s0 = _split_of(spatial[..., 0], spatial[..., 1], x0, y0)
    p = torch.where(loopmask, _cdiv(t1, s0), 1)               # per-PE iters

    pos0 = _positions(order[..., 0, :])
    pos1 = _positions(order[..., 1, :])
    pos2 = _positions(order[..., 2, :])

    # ---- compute cycles ----------------------------------------------------
    pe_pass = p.to(F).prod(-1)                # cycles per core-tile pass
    n1_tot = n1.to(F).prod(-1)
    n2_tot = n2.to(F).prod(-1)
    total_macs = torch.where(loopmask, bounds, 1).to(F).prod(-1)
    macs_per_chip = total_macs / n_chip.to(F)  # useful work (pre-padding)

    # ---- footprints --------------------------------------------------------
    f1 = _footprint(A, dmask, t1) * tm        # core-buffer tile elems
    f2 = _footprint(A, dmask, t2) * tm        # chiplet-buffer tile elems
    core_buf_bytes = f1.sum(-1) * bpe
    chip_buf_bytes = f2.sum(-1) * bpe

    # ---- level-0: core buffer <-> PE registers ----------------------------
    # a PE-array spatial loop a tensor does NOT depend on forwards the same
    # element across the array (systolic multicast): the buffer feeds only
    # the distinct elements at the array edge, n_pe / m0 per tensor
    r0 = _refills(rel, pos0, p, loopmask)                     # per PE per pass
    d0 = _distinct(rel, p, loopmask)
    rd0 = torch.where(is_out, r0 + (r0 - d0).clamp_min(0.0), r0)
    m0 = _multicast(rel, spatial[..., 0], spatial[..., 1], x0, y0)
    core_acc_pass = (rd0 * tm / m0 * n_pe_f[..., None]).sum(-1) * bpe
    core_acc_total = core_acc_pass * n1_tot * n2_tot * n_core_f

    # ---- level-1: chiplet buffer <-> core buffers --------------------------
    r1 = _refills(rel, pos1, n1, loopmask)    # t1-tile refills per pass
    d1 = _distinct(rel, n1, loopmask)
    rw1 = torch.where(is_out, 2.0 * r1 - d1, r1)  # outputs: write + psum rd
    m1 = _multicast(rel, spatial[..., 2], spatial[..., 3], x1, y1)
    # broadcast on the intra-chiplet NoC: a tile multicast to m1 cores
    # crosses the shared fabric once (bus/tree multicast model)
    chipbuf_acc_pass = (rw1 * f1 * tm / m1).sum(-1) * bpe * n_core_f
    noc_bytes_pass = chipbuf_acc_pass
    chipbuf_acc_total = chipbuf_acc_pass * n2_tot
    noc_bytes_total = noc_bytes_pass * n2_tot

    # ---- level-2: external (network / DRAM) <-> chiplet buffer -------------
    r2 = _refills(rel, pos2, n2, loopmask)
    d2 = _distinct(rel, n2, loopmask)
    rw2 = torch.where(is_out, 2.0 * r2 - d2, r2)
    ext_bytes = (rw2 * f2 * tm).sum(-1) * bpe                 # per chiplet
    m2 = _multicast(rel, spatial[..., 4], spatial[..., 5], x2, y2)
    # external traffic split per tensor (inputs in, outputs out) for the
    # communication-graph construction
    ext_in_t = torch.where(is_out, 0.0, r2 * f2 * tm) * bpe
    ext_out_t = torch.where(is_out, rw2 * f2 * tm, 0.0) * bpe

    # ---- pipelined delays (ns; paper Sec III-C max-composition) ------------
    # pe_pass + output-stationary systolic fill/drain skew (2X + Y - 2)
    skew = (2 * x0 + y0 - 2).to(F)
    d_pe = (pe_pass + skew) / tech.clock_ghz
    d_b0 = core_acc_pass / tech.core_buf_bw
    core_pass_d = torch.maximum(d_pe, d_b0)
    d_noc = noc_bytes_pass / tech.chip_noc_bw
    d_b1 = chipbuf_acc_pass / tech.chip_buf_bw
    chip_pass_d = torch.maximum(n1_tot * core_pass_d,
                                torch.maximum(d_noc, d_b1))
    d_ext_pass = (ext_bytes / n2_tot) / _clamp_min(ext_bw, 1e-6)
    # each external tile also pays a fixed launch overhead (0 by default)
    delay = n2_tot * (torch.maximum(chip_pass_d, d_ext_pass)
                      + tech.t_tile_overhead_ns)              # per chiplet, ns

    util = macs_per_chip / (n_pe_f * n_core_f * delay
                            * tech.clock_ghz).clamp_min(1e-9)

    return dict(
        delay_ns=delay,
        ext_tiles=n2_tot,
        compute_cycles=n2_tot * n1_tot * pe_pass,
        utilization=util,
        total_macs=total_macs,
        n_chiplets=n_chip.to(F), n_cores=n_core_f, n_pes=n_pe_f,
        core_buf_bytes=core_buf_bytes, chip_buf_bytes=chip_buf_bytes,
        core_acc_bytes=core_acc_total,            # per chiplet
        chipbuf_acc_bytes=chipbuf_acc_total,      # per chiplet
        noc_bytes=noc_bytes_total,                # per chiplet
        ext_bytes=ext_bytes,                      # per chiplet
        ext_in_bytes_t=ext_in_t, ext_out_bytes_t=ext_out_t,
        ext_multicast_t=m2,
        reg_acc_bytes=((rd0 * tm).sum(-1) * bpe
                       * n_pe_f * n1_tot * n2_tot * n_core_f),
        mac_count=macs_per_chip * n_chip.to(F),
    )
