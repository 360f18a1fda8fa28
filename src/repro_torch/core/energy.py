"""Accelergy-style energy and area model (paper Sec. IV-A): the port of
``repro.core.energy``, batched over leading dims.

Inputs are the access counts of ``dataflow.analyze_chiplet`` and the
network byte-hop totals of ``network.evaluate_network``; constants are
documented in ``constants.TechConstants``.  Output units: pJ and mm^2.
"""

from __future__ import annotations

import torch

from .constants import DEFAULT_TECH, TechConstants

F = torch.float32


def tech_table(values, device) -> torch.Tensor:
    """A per-packaging tech tuple as a float32 tensor (entries may be
    Python numbers or 0-d tensors)."""
    return torch.stack([torch.as_tensor(v, dtype=F, device=device)
                        for v in values])


def chiplet_energy_pj(an: dict, tech: TechConstants = DEFAULT_TECH):
    """Energy for one workload executing on its chiplet cluster.

    ``an`` is the analyze_chiplet dict; per-chiplet byte counts are scaled
    by the cluster size here.  DRAM and D2D energies are added at system
    level from the communication-graph traffic (avoids double counting).
    """
    nchip = an["n_chiplets"]
    e_mac = an["mac_count"] * tech.e_mac_pj
    e_reg = an["reg_acc_bytes"] * nchip * 8.0 * tech.e_reg_pj_bit
    e_core = an["core_acc_bytes"] * nchip * 8.0 * tech.e_core_sram_pj_bit
    # chiplet buffer: read by core refills + written by external fills
    chip_bits = (an["chipbuf_acc_bytes"] + an["ext_bytes"]) * nchip * 8.0
    e_chip = chip_bits * tech.e_chip_sram_pj_bit
    return e_mac + e_reg + e_core + e_chip


def system_network_energy_pj(net: dict, packaging,
                             tech: TechConstants = DEFAULT_TECH):
    """D2D link + router + DRAM energy from network traffic totals.
    ``packaging``: (P,) int64 in [0, 2]."""
    e_d2d = tech_table(tech.e_d2d_pj_bit, packaging.device)[packaging]
    e_d2d = net["d2d_byte_hops"] * 8.0 * e_d2d
    e_rt = net["router_byte_hops"] * 8.0 * tech.e_router_pj_bit
    e_dram = net["dram_bytes"] * 8.0 * tech.e_dram_pj_bit
    return e_d2d + e_rt + e_dram


def chiplet_area_mm2(an: dict, io_bw_gbps, packaging,
                     tech: TechConstants = DEFAULT_TECH):
    """Area of ONE chiplet: cores (PEs + core buffer) + chiplet buffer +
    router + I/O bump area reservation  bw / D_bw * N_link  (Sec. IV-B).
    ``an`` fields are (P, W); ``io_bw_gbps`` and ``packaging`` are (P,)."""
    dev = packaging.device
    bw_density = tech_table(tech.bw_density, dev)[packaging][:, None]
    n_link = tech_table(tech.n_link_io, dev)[packaging][:, None]
    core = (an["n_pes"] * tech.a_pe
            + an["core_buf_bytes"] / float(2**20) * tech.a_sram_per_mb
            + tech.a_core_overhead)
    chip = (an["n_cores"] * core
            + an["chip_buf_bytes"] / float(2**20) * tech.a_sram_per_mb
            + tech.a_router + tech.a_chiplet_overhead)
    # 4 in-package links per chiplet node (mesh degree); N_link scales how
    # many of them cross bumps for the chosen packaging
    io = io_bw_gbps[:, None] / bw_density.clamp_min(1e-6) * 4.0 * n_link
    return chip + io
