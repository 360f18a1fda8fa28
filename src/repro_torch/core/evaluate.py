"""System-level evaluation of populations of chiplet-accelerator designs.

The port of ``repro.core.evaluate``.  Composes the per-chiplet dataflow
analysis, the contention-aware network model, the energy/area models and
the Eq.-1 cost model into the paper's pipeline performance model
(Sec. III-C):

    Lat = max_path sum D(stage),   Thr = 1 / max_stage D,
    T_total = Lat + (B - 1) / Thr          (B = pipeline ticks)

Where the reference ``vmap``s one design at a time, ``evaluate_arrays``
takes a whole population: every design field carries a leading population
dimension P.  A ``SystemSpec`` (static, per workload graph) fixes the padded
dims W workloads x CH chiplets-per-cluster x E edges.  A *design* is a dict
of int32 tensors (see ``encoding.py``):

    shape   (P, W, 6)  raw dims [x0,y0,x1,y1,x2,y2]
    spatial (P, W, 6)  loop ids
    order   (P, W, 3, L)
    tiling  (P, W, 2, L)
    pipe    (P, W)    pipelined loop id (L => none)
    logB    (P,)      log2 pipeline ticks
    packaging (P,)    0..2
    family  (P,)      network family 0..3
    placement (P, W*CH) global chiplet -> node id
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..runtime import resolve_device
from .constants import DEFAULT_TECH, TechConstants
from .cost import package_cost
from .dataflow import analyze_chiplet
from .energy import (chiplet_area_mm2, chiplet_energy_pj,
                     system_network_energy_pj, tech_table)
from .network import (MAX_NODES, evaluate_network, next_hop_tensor,
                      route_links)
from .workload import MAX_LOOPS, MAX_TENSORS, WorkloadGraph

F = torch.float32
BIG = 1e18

# the reference dtype of every spec array (integer arrays int32, masks bool)
_SPEC_DTYPES = dict(
    bounds=torch.int32, loopmask=torch.bool, A=torch.int8,
    tmask=torch.bool, dmask=torch.bool, is_out=torch.bool, wmask=torch.bool,
    esrc=torch.int32, edst=torch.int32, edst_tensor=torch.int32,
    emask=torch.bool, ext_in=torch.bool, fin_out=torch.bool)


def spec_tensors(arrays: Dict, device) -> Dict[str, torch.Tensor]:
    """Spec arrays (numpy or tensors) as tensors on ``device``, each cast
    to the reference's dtype."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device,
                                          dtype=_SPEC_DTYPES.get(k))
            for k, v in arrays.items()}


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Static description of a workload graph, padded (numpy arrays, the
    same content and dtypes as the reference's)."""
    W: int                       # max workloads
    CH: int                      # max chiplets per cluster
    E: int                       # max edges
    arrays: Dict[str, np.ndarray]
    graph: WorkloadGraph

    @staticmethod
    def build(graph: WorkloadGraph, ch_max: int = 8) -> "SystemSpec":
        W = len(graph.workloads)
        E = max(len(graph.edges), 1)
        wl = [w.to_arrays() for w in graph.workloads]
        arr = {k: np.stack([d[k] for d in wl]) for k in wl[0]}
        arr["wmask"] = np.ones(W, bool)

        tname_idx = [
            {t.name: i for i, t in enumerate(w.tensors)}
            for w in graph.workloads
        ]
        esrc = np.zeros(E, np.int32)
        edst = np.zeros(E, np.int32)
        edst_tensor = np.zeros(E, np.int32)
        emask = np.zeros(E, bool)
        for i, e in enumerate(graph.edges):
            esrc[i], edst[i] = e.src, e.dst
            edst_tensor[i] = tname_idx[e.dst][e.tensor_dst]
            emask[i] = True
        arr.update(esrc=esrc, edst=edst, edst_tensor=edst_tensor, emask=emask)

        ext_in = np.zeros((W, MAX_TENSORS), bool)
        for wi, tn in graph.external_inputs():
            ext_in[wi, tname_idx[wi][tn]] = True
        fin_out = np.zeros((W, MAX_TENSORS), bool)
        for wi, tn in graph.final_outputs():
            fin_out[wi, tname_idx[wi][tn]] = True
        arr.update(ext_in=ext_in, fin_out=fin_out)
        return SystemSpec(W=W, CH=ch_max, E=E, arrays=arr, graph=graph)


def _tick_bounds(bounds, loopmask, pipe_loop, B):
    """Divide the pipelined loop's bound by B (the per-tick sub-problem).
    bounds/loopmask: (W, L); pipe_loop: (P, W); B: (P,) int -> (P, W, L)."""
    l = torch.arange(MAX_LOOPS, device=bounds.device)
    hit = (l == pipe_loop[..., None]) & loopmask
    Bb = B[:, None, None]
    return torch.where(hit, ((bounds + Bb - 1) // Bb).clamp_min(1), bounds)


def evaluate_system(spec: SystemSpec, design: Dict,
                    tech: TechConstants = DEFAULT_TECH) -> Dict:
    """Full PPA + cost evaluation of a population of design points."""
    dev = design["shape"].device
    return evaluate_arrays(spec_tensors(spec.arrays, dev), design,
                           (spec.W, spec.CH, spec.E), tech)


def evaluate_arrays(arr: Dict, design: Dict, dims: Tuple[int, int, int],
                    tech: TechConstants = DEFAULT_TECH,
                    lanes: int = 1) -> Dict:
    """Evaluate a population: ``arr`` are the spec tensors (see
    ``spec_tensors``), ``design`` a dict of (P, ...) int tensors.  Returns
    a dict of (P,)-shaped metrics (plus per-stage/per-edge delays).

    The spec tensors are either shared by the whole population (``bounds``
    (W, L), the reference's layout) or given per row (every tensor with a
    leading P axis, ``bounds`` (P, W, L)): then each design is evaluated
    against its own problem, as a fused run's ``lanes`` need.  Its rows
    are ``lanes`` equal blocks, one problem each; the card's one float
    product (the link loads) runs block by block at the unfused shape, so
    every lane sums in the order its unfused run does."""
    W, CH, E = dims
    dev = design["shape"].device
    P = design["shape"].shape[0]

    def cols(x, idx):                # x[:, idx]; idx shared or per row
        return x[:, idx] if idx.dim() == 1 else x.gather(1, idx)

    def cat_idx(*parts):             # concatenated column indices
        if all(p.dim() == 1 for p in parts):
            return torch.cat(parts)
        return torch.cat([p.expand(P, -1) for p in parts], 1)
    wl = {k: arr[k] for k in
          ("bounds", "loopmask", "A", "tmask", "dmask", "is_out")}

    pkg = design["packaging"].long().clamp(0, 2)
    cap = tech_table(tech.link_bw_cap, dev)[pkg]                 # (P,)
    logB = design["logB"].to(torch.int32)
    B = (2 ** logB).to(F)
    bounds_t = _tick_bounds(wl["bounds"], wl["loopmask"], design["pipe"],
                            2 ** logB)                           # (P, W, L)

    def analyze(ext_bw):                     # ext_bw: (P, W)
        return analyze_chiplet(dict(wl, bounds=bounds_t), design["shape"],
                               design["spatial"], design["order"],
                               design["tiling"], tech=tech,
                               ext_bw_gbps=ext_bw)

    # ---- per-workload chiplet analysis (per pipeline tick) -----------------
    an0 = analyze(cap[:, None].expand(P, W))
    d_stage0 = an0["delay_ns"]                                   # (P, W)

    n_chips = an0["n_chiplets"].to(torch.int64)                  # (P, W)
    base = torch.cumsum(n_chips, 1) - n_chips                    # global base
    n_nodes = n_chips.sum(1)                                     # (P,)
    placement = design["placement"].long()                       # (P, W*CH)

    # ---- communication graph (flows) ---------------------------------------
    # block A: DRAM->chiplet external-input streams  (W*CH flows)
    # block B: chiplet->DRAM final-output writebacks (W*CH flows)
    # block C: producer->consumer intermediate flows (E*CH flows)
    def chip_node(wi, j):                    # wi: (K,) or (P, K); j: (P, K)
        g = cols(base, wi) + j
        return placement.gather(1, g.clamp(0, W * CH - 1))

    wgrid = torch.arange(W, device=dev).repeat_interleave(CH)    # (W*CH,)
    jgrid = torch.arange(CH, device=dev).repeat(W)
    chip_valid = jgrid < n_chips[:, wgrid]                       # (P, W*CH)
    node_of = chip_node(wgrid, jgrid.expand(P, W * CH))

    ein = an0["ext_in_bytes_t"]                                  # (P, W, T)
    eout = an0["ext_out_bytes_t"]
    dram_in_vol = (ein * arr["ext_in"]).sum(-1)[:, wgrid]        # (P, W*CH)
    dram_out_vol = (eout * arr["fin_out"]).sum(-1)[:, wgrid]

    dram_node = n_nodes[:, None].expand(P, W * CH)
    srcA, dstA = dram_node, node_of
    volA, mA = dram_in_vol, chip_valid & (dram_in_vol > 0)
    srcB, dstB = node_of, dram_node
    volB, mB = dram_out_vol, chip_valid & (dram_out_vol > 0)

    egrid = torch.arange(E, device=dev).repeat_interleave(CH)    # (E*CH,)
    jg = torch.arange(CH, device=dev).repeat(E)
    w1 = arr["esrc"].long()[..., egrid]          # (E*CH,) or (P, E*CH)
    w2 = arr["edst"].long()[..., egrid]
    mC = arr["emask"][..., egrid] & (jg < cols(n_chips, w2))
    t_dst = arr["edst_tensor"].long()[..., egrid].clamp(0, MAX_TENSORS - 1)
    if w2.dim() == 1:
        volC = ein[:, w2, t_dst]                  # per consumer chiplet
    else:
        volC = ein[torch.arange(P, device=dev)[:, None], w2, t_dst]
    srcC = chip_node(w1, jg % cols(n_chips, w1).clamp_min(1))
    dstC = chip_node(w2, jg.expand(P, E * CH))

    src = torch.cat([srcA, srcB, srcC], 1)
    dst = torch.cat([dstA, dstB, dstC], 1)
    vol = torch.cat([volA, volB, volC], 1)
    fmask = torch.cat([mA, mB, mC], 1)
    fw_src = cat_idx(wgrid, wgrid, w1)                           # stage of src
    fw_dst = cat_idx(wgrid, wgrid, w2)
    is_dram_f = torch.cat([torch.ones(2 * W * CH, dtype=torch.bool,
                                      device=dev),
                           torch.zeros(E * CH, dtype=torch.bool,
                                       device=dev)])

    # bwr_{i,j} = |Omega| / min(D(v_i), D(v_j))  (DRAM side: consumer delay)
    d_src = torch.where(is_dram_f, BIG, cols(d_stage0, fw_src))
    d_min = torch.minimum(d_src, cols(d_stage0, fw_dst))
    bwr = vol / d_min.clamp_min(1.0)

    # ---- network: provision at hotspot, cap by packaging -------------------
    tcode = (design["family"].long() * (MAX_NODES + 1)
             + n_nodes.clamp(1, MAX_NODES))
    nh_all = next_hop_tensor(dev)
    nh = nh_all[tcode.clamp(0, nh_all.shape[0] - 1)]             # (P, N, N)
    route = route_links(nh, src, dst)        # routing is shared by both passes
    pre = evaluate_network(route, bwr, vol, fmask, cap, tech.dram_bw,
                           tech.router_delay_ns, n_nodes, lanes)
    link_bw = torch.minimum(pre["hotspot"].clamp_min(1.0), cap)
    net = evaluate_network(route, bwr, vol, fmask, link_bw, tech.dram_bw,
                           tech.router_delay_ns, n_nodes, lanes)

    # ---- fixed-point pass: refine stage delays with achieved inbound bw ----
    # DRAM streaming overlaps compute INSIDE the stage (max(D_C, D_B, D_A),
    # Sec III-C); each workload's effective external bandwidth per chiplet is
    # what its block-A flows achieved under contention
    ebw_f = torch.where(fmask, vol / net["delay_ns"].clamp_min(1.0), 0.0)
    ebw_A = torch.where(mA, ebw_f[:, : W * CH], 0.0)
    if dev.type == "cuda":
        # a workload's CH chiplets are adjacent: a reduction, in a fixed
        # order (the card's index_add_ adds with atomics, in any order)
        inbound = ebw_A.reshape(P, W, CH).sum(-1)
    else:
        inbound = torch.zeros(P, W, dtype=F, device=dev).index_add_(
            1, wgrid, ebw_A)
    per_chip_bw = inbound / an0["n_chiplets"].clamp_min(1.0)
    per_chip_bw = torch.where(per_chip_bw > 0, per_chip_bw, cap[:, None])
    an = analyze(torch.minimum(per_chip_bw, cap[:, None]))
    d_stage = an["delay_ns"]                                     # (P, W)

    # ---- transfer-stage delays ---------------------------------------------
    # DRAM in/out contributes only the FIRST/LAST tile fill to the path (the
    # bulk is overlapped inside the compute stage); producer->consumer edges
    # are full pipeline transfer stages D(e) = max over the edge's flows
    fdel = torch.where(fmask, net["delay_ns"], 0.0)
    hop_lat = net["hops"] * tech.router_delay_ns
    tiles_w = an["ext_tiles"].clamp_min(1.0)                     # (P, W)
    first_fill = hop_lat + (fdel - hop_lat) / cols(tiles_w, fw_src)

    def scatter_max(n, index, values):       # zeros(n).at[index].max(values)
        out = torch.zeros(P, n, dtype=F, device=dev)
        return out.scatter_reduce_(1, index.expand(P, -1), values, "amax",
                                   include_self=True)

    d_in = scatter_max(W, wgrid, torch.where(mA, first_fill[:, : W * CH],
                                             0.0))
    d_out = scatter_max(W, wgrid, torch.where(
        mB, first_fill[:, W * CH: 2 * W * CH], 0.0))
    eflow = fdel[:, 2 * W * CH:]
    d_edge = scatter_max(E, egrid, torch.where(mC, eflow, 0.0))

    # ---- DAG longest path (max-plus relaxation over edges, W rounds) -------
    esrc, edst = arr["esrc"].long(), arr["edst"].long()
    emask = arr["emask"]
    dist = d_in + d_stage                                        # (P, W)
    for _ in range(W):
        upd = cols(dist, esrc) + d_edge + cols(d_stage, edst)
        upd = torch.where(emask, upd, -BIG)
        dist = dist.scatter_reduce(1, edst.expand(P, -1), upd, "amax",
                                   include_self=True)
    lat_tick = (dist + d_out).amax(1)

    max_stage = torch.maximum(
        d_stage.amax(1),
        torch.maximum(torch.where(emask, d_edge, 0.0).amax(1),
                      torch.maximum(d_in.amax(1), d_out.amax(1))))
    latency = lat_tick + (B - 1.0) * max_stage
    throughput = 1.0 / max_stage.clamp_min(1e-9)

    # ---- energy -------------------------------------------------------------
    e_compute = chiplet_energy_pj(an, tech).sum(1) * B
    e_net = system_network_energy_pj(net, pkg, tech) * B
    energy = e_compute + e_net

    # ---- area / cost --------------------------------------------------------
    area_w = chiplet_area_mm2(an, link_bw, pkg, tech)            # (P, W)
    die_areas = torch.where(chip_valid, area_w[:, wgrid], 0.0)   # (P, W*CH)
    cost = package_cost(die_areas, pkg, tech)
    area = die_areas.sum(1)

    # ---- calibration corrections (1.0 by default: exact identity) -----------
    cl, ce = tech.corr_latency, tech.corr_energy
    ca, cc = tech.corr_area, tech.corr_cost
    latency, lat_tick = latency * cl, lat_tick * cl
    throughput = throughput / cl
    d_stage, d_edge = d_stage * cl, d_edge * cl
    e_compute, e_net = e_compute * ce, e_net * ce
    energy = energy * ce
    cost, area = cost * cc, area * ca

    return dict(
        latency_ns=latency, lat_tick_ns=lat_tick, throughput_per_ns=throughput,
        energy_pj=energy, edp=energy * 1e-12 * latency * 1e-9,
        cost_usd=cost, area_mm2=area,
        utilization=(an["utilization"] * an["n_chiplets"]).sum(1)
        / an["n_chiplets"].sum(1).clamp_min(1.0),
        hotspot_gbps=pre["hotspot"], link_bw_gbps=link_bw,
        n_nodes=n_nodes, stage_delays_ns=d_stage, edge_delays_ns=d_edge,
        energy_compute_pj=e_compute, energy_network_pj=e_net,
        dram_bytes=net["dram_bytes"] * B,
        d2d_byte_hops=net["d2d_byte_hops"] * B,
    )


def make_batch_evaluator(spec: SystemSpec, tech: TechConstants = DEFAULT_TECH,
                         device="cuda"):
    """Population evaluator for one spec: designs (dict of (P, ...) int
    tensors on ``device``) -> metrics dict.  The spec arrays move to the
    device once."""
    dev = resolve_device(device)
    arr = spec_tensors(spec.arrays, dev)
    dims = (spec.W, spec.CH, spec.E)

    def run(design):
        return evaluate_arrays(arr, design, dims, tech)
    return run
