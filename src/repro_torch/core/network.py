"""In-package network model (paper Sec. III-A Def. 2 + Sec. III-C).

The port of ``repro.core.network``.  Communication graph: flows (src node,
dst node, bandwidth-requirement bwr, volume bytes).  The network is one of
four deterministic-routing topology families over up to ``MAX_NODES``
chiplet nodes plus one DRAM node:

    0 chain   — 1D line, dimension-order routing
    1 ring    — shortest direction, clockwise on tie
    2 mesh    — row-major 2D grid (rows = largest divisor <= sqrt(n)), XY routing
    3 star    — hub at node 0

DRAM (memory-controller) node = index ``n_nodes``; it attaches to column-0
nodes of a mesh and to node 0 otherwise.

Flow control: links are provisioned uniformly at the *hotspot* requirement,
capped by the packaging's per-link bandwidth; flows through an overloaded
link are throttled in proportion to their requirements:

    ebw_c^f = bwr_f * min(1, bw_c / load_c),   ebw_f = min over links on path
    D(e)    = |f| * t_s + bytes / ebw_f

Routing is precomputed on the host into next-hop tables (numpy, identical
to the reference's); the contention evaluation walks every flow of every
design in the population at once, one hop per loop step.  Out-of-range
node ids (designs with more chiplets than table slots) follow the
reference's gather/scatter semantics explicitly: reads clamp the index,
scatter-adds drop it.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

MAX_NODES = 36          # paper Sec. IV-C: placement field is up to 36 nodes
N_TOT = MAX_NODES + 1   # + DRAM node
MAX_HOPS = 40           # >= diameter of any supported topology (chain-36 + DRAM)
FAM_CHAIN, FAM_RING, FAM_MESH, FAM_STAR = 0, 1, 2, 3
N_FAMILIES = 4

F = torch.float32


def _mesh_dims(n: int):
    r = int(math.isqrt(n))
    while r > 1 and n % r != 0:
        r -= 1
    return r, n // r          # rows, cols


def _build_next_hop(family: int, n: int) -> np.ndarray:
    """Next-hop table NH[s, d] for n chiplet nodes + DRAM node (= index n).

    NH[s, d] = next node on the deterministic path s -> d; NH[d, d] = d.
    Unused node slots route to themselves.
    """
    # default NH[s, d] = d (arrived / unused slots terminate immediately)
    NH = np.tile(np.arange(N_TOT, dtype=np.int16)[None, :], (N_TOT, 1))
    dram = n

    if family == FAM_MESH:
        rows, cols = _mesh_dims(n)
    for s in range(n):
        for d in range(n):
            if s == d:
                continue
            if family == FAM_CHAIN:
                nxt = s + 1 if d > s else s - 1
            elif family == FAM_RING:
                fwd = (d - s) % n
                bwd = (s - d) % n
                nxt = (s + 1) % n if fwd <= bwd else (s - 1) % n
            elif family == FAM_MESH:
                sr, sc = divmod(s, cols)
                dr, dc = divmod(d, cols)
                if sc != dc:                       # X first
                    nxt = sr * cols + (sc + (1 if dc > sc else -1))
                else:                              # then Y
                    nxt = (sr + (1 if dr > sr else -1)) * cols + sc
            else:                                  # star via hub 0
                nxt = d if s == 0 else 0
            NH[s, d] = nxt
    # DRAM attachments
    if family == FAM_MESH:
        rows, cols = _mesh_dims(n)
        for d in range(n):
            NH[dram, d] = (d // cols) * cols       # enter at column 0, own row
        for s in range(n):
            sr, sc = divmod(s, cols)
            NH[s, dram] = dram if sc == 0 else sr * cols + (sc - 1)
    else:
        # DRAM attaches to node 0 only: enter/leave the network via node 0.
        for d in range(n):
            NH[dram, d] = np.int16(0)
        for s in range(n):
            NH[s, dram] = np.int16(dram) if s == 0 else NH[s, 0]
    return NH


@lru_cache(maxsize=1)
def next_hop_tables() -> np.ndarray:
    """Stacked (148, 37, 37) int16 NH tables, indexed by
    family * (MAX_NODES+1) + n."""
    out = np.zeros((N_FAMILIES * (MAX_NODES + 1), N_TOT, N_TOT), np.int16)
    for fam in range(N_FAMILIES):
        for n in range(1, MAX_NODES + 1):
            out[fam * (MAX_NODES + 1) + n] = _build_next_hop(fam, n)
    return out


def topo_code(family: int, n_nodes: int) -> int:
    """The row of ``next_hop_tables()`` of topology ``family`` over
    ``n_nodes`` nodes."""
    return family * (MAX_NODES + 1) + n_nodes


def next_hop_tensor(device) -> torch.Tensor:
    """``next_hop_tables()`` as an int64 tensor on ``device`` (converted
    once per device: torch indexes with long)."""
    return _next_hop_on(str(torch.device(device)))


@lru_cache(maxsize=None)
def _next_hop_on(device: str) -> torch.Tensor:
    return torch.as_tensor(next_hop_tables().astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# batched contention evaluation
# ---------------------------------------------------------------------------
def route_links(nh, src, dst):
    """Walk the paths of every flow of every design.

    nh: (P, N_TOT, N_TOT) int64 next-hop tables; src/dst: (P, F) int64.
    Returns (u, v, hops): u/v (MAX_HOPS, P, F) int64 — the link (u, v)
    taken at each hop (u == v once arrived => no link) — and hops (P, F)
    float32.  Out-of-range node ids clamp when read from the table, as the
    reference's gather does; the raw source id is kept as the first hop's
    ``u``."""
    P = nh.shape[0]
    flat = nh.reshape(P, N_TOT * N_TOT)
    col = dst.clamp(0, N_TOT - 1)
    cur = src
    us, vs = [], []
    for _ in range(MAX_HOPS):
        nxt = flat.gather(1, cur.clamp(0, N_TOT - 1) * N_TOT + col)
        us.append(cur)
        vs.append(nxt)
        cur = nxt
    u, v = torch.stack(us), torch.stack(vs)
    hops = (u != v).sum(0).to(F)
    return u, v, hops


def link_load_dense(u, v, w, lanes: int = 1):
    """Per-link sums of ``w`` over the links (u, v) its entries take, as a
    product of one-hot matrices: (P, N_TOT * N_TOT), link id u * N_TOT + v.

    u, v, w: (MAX_HOPS, P, F); ``w`` is 0 wherever (u, v) is no link of the
    table.  The card's ``scatter_add_`` adds with atomics, whose order (and
    so rounding) changes from call to call; a batched GEMM adds in a fixed
    order, so one population sums to the same bits on every call.  Each
    product is a requirement times 1 or 0, so the requirements must be
    finite (they are volumes over delays of at least 1 ns).

    ``lanes`` > 1 splits the population into that many equal blocks (a
    fused run's problems) and takes each block's product on its own, at
    the unfused shape: a batched GEMM of another batch count may pick
    another algorithm, and so another order of the sum."""
    H, P, Fl = u.shape
    if lanes > 1:
        n = P // lanes
        return torch.cat([link_load_dense(u[:, i * n:(i + 1) * n],
                                          v[:, i * n:(i + 1) * n],
                                          w[:, i * n:(i + 1) * n])
                          for i in range(lanes)])
    nodes = torch.arange(N_TOT, device=u.device)

    def rows(x):                                 # (H, P, F) -> (P, H * F)
        return x.permute(1, 0, 2).reshape(P, H * Fl, 1)
    wu = torch.where(rows(u.clamp(0, N_TOT - 1)) == nodes, rows(w), 0.0)
    ov = (rows(v.clamp(0, N_TOT - 1)) == nodes).to(w.dtype)
    return torch.bmm(wu.transpose(1, 2), ov).reshape(P, N_TOT * N_TOT)


def evaluate_network(route, bwr, vol_bytes, fmask, link_bw, dram_bw,
                     router_delay_ns, n_nodes, lanes: int = 1):
    """Contention-aware per-flow delay (paper Sec. III-C last equation).

    route:     ``route_links`` output (u, v, hops) for the flows
    bwr:       (P, F) bandwidth requirement GB/s
    vol_bytes: (P, F) transfer volume
    fmask:     (P, F) bool valid-flow mask
    link_bw:   (P,) provisioned chiplet-link bandwidth (GB/s)
    n_nodes:   (P,) chiplet node count (= the DRAM node id)
    lanes:     equal blocks of the population summed apart on the card
               (see ``link_load_dense``)
    Returns dict(delay_ns (P, F), hops (P, F), hotspot (P,),
    d2d_byte_hops, dram_bytes, router_byte_hops (P,)).
    """
    u, v, hops = route
    H, P, Fl = u.shape
    active = (u != v) & fmask[None]
    lid = u * N_TOT + v                          # directed link id
    n_links = N_TOT * N_TOT

    # sum of the requirements onto links; ids past the table are dropped,
    # as the reference's scatter drops them
    inb = lid < n_links
    w = torch.where(active & inb, bwr[None], 0.0)
    if bwr.device.type == "cuda":
        load = link_load_dense(u, v, w, lanes)
    else:
        load = torch.zeros(P, n_links, dtype=F, device=bwr.device)
        load.scatter_add_(
            1, torch.where(inb, lid, 0).permute(1, 0, 2).reshape(P, H * Fl),
            w.permute(1, 0, 2).reshape(P, H * Fl))
    hotspot = load.amax(1)

    # per-link capacity: DRAM-attached links run at dram_bw, others at link_bw
    nn = n_nodes[None, :, None]
    is_dram_link = (u == nn) | (v == nn)
    cap = torch.where(is_dram_link, dram_bw, link_bw[None, :, None].to(F))
    # advanced indexing, not gather: the same values, and its backward (a
    # calibration fit's) adds a link's duplicates in sorted order on the
    # card, where gather's backward adds them with atomics, in any order
    rows = torch.arange(P, device=load.device)[:, None]
    link_load = load[rows, lid.clamp(0, n_links - 1).permute(1, 0, 2)
                     .reshape(P, H * Fl)
                     ].reshape(P, H, Fl).permute(1, 0, 2)        # (H, P, F)
    ratio = torch.where(active,
                        torch.clamp(cap / link_load.clamp_min(1e-9), max=1.0),
                        1.0)
    min_ratio = ratio.amin(0)                                    # (P, F)
    ebw = (bwr * min_ratio).clamp_min(1e-9)
    delay = hops * router_delay_ns + vol_bytes / ebw
    delay = torch.where(fmask, delay, 0.0)

    # bits x hops on chiplet-to-chiplet links (for D2D energy); DRAM-link
    # traversals counted separately (DRAM access energy)
    fm = fmask.to(F)
    d2d_hops = (active & ~is_dram_link).to(F).sum(0)
    dram_hops = (active & is_dram_link).to(F).sum(0)
    return dict(delay_ns=delay, hops=hops, hotspot=hotspot,
                d2d_byte_hops=(vol_bytes * d2d_hops * fm).sum(-1),
                dram_bytes=(vol_bytes * dram_hops.clamp(max=1.0) * fm).sum(-1),
                router_byte_hops=(vol_bytes * hops * fm).sum(-1))
