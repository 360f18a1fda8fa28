"""Technology constants for the Monad models (energy / area / cost / network).

The PyTorch port's own copy of ``repro.core.constants`` (the dataclass, the
packaging ids, the stable ``tech_key`` digest and the calibration field
lists): the port imports nothing of the JAX package.  ``tech_key`` must
stay byte-identical to the reference's so both packages agree on a tech's
identity.

The paper sources these from Accelergy [34], ICKnowledge [8] and the UCIe
white paper [31]; none of those tools/tables ship offline, so every constant
here is a documented public-literature value.  Absolute outputs therefore
differ from the paper's; the *relative* experiments (Fig. 3/7/8/9/10) are what
the benchmarks reproduce.

Conventions
-----------
* energy:   pJ  (per event or per bit, as named)
* area:     mm^2
* cost:     USD
* bandwidth: GB/s  (= bytes/ns)
* time:     ns (1 GHz core clock -> 1 cycle = 1 ns)
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

# ---------------------------------------------------------------------------
# Packaging technology ids (paper Sec. IV-B: encoded as 0-2)
# ---------------------------------------------------------------------------
PKG_ORGANIC = 0          # organic substrate
PKG_PASSIVE = 1          # passive silicon interposer
PKG_ACTIVE = 2           # active silicon interposer
PACKAGINGS = (PKG_ORGANIC, PKG_PASSIVE, PKG_ACTIVE)
PACKAGING_NAMES = ("organic", "passive-interposer", "active-interposer")


@dataclasses.dataclass(frozen=True)
class TechConstants:
    # --- timing -----------------------------------------------------------
    clock_ghz: float = 1.0                # core clock; 1 cycle == 1 ns
    router_delay_ns: float = 20.0         # t_s: per-hop switch delay (head flit)
    # fixed per-external-tile launch overhead (DMA descriptor setup, drain).
    # Real systolic arrays pay a constant cost each time a tile's operands
    # are (re)staged from DRAM; the pure pipeline model omits it.  Default 0
    # keeps the uncalibrated model bit-identical; calibration fits it.
    t_tile_overhead_ns: float = 0.0

    # --- datatype ---------------------------------------------------------
    bytes_per_elem: int = 2               # fp16/bf16 operands

    # --- energy (pJ) ------------------------------------------------------
    # MAC @ 28nm, 16-bit (Horowitz ISSCC'14 scaled)
    e_mac_pj: float = 1.0
    # register-file access, per bit
    e_reg_pj_bit: float = 0.03
    # core (L1) SRAM buffer, per bit (64-256 KB class)
    e_core_sram_pj_bit: float = 0.30
    # chiplet (L2) SRAM buffer, per bit (MB class); paper cites 0.81 pJ/bit [28]
    e_chip_sram_pj_bit: float = 0.81
    # DRAM access per bit (LPDDR class)
    e_dram_pj_bit: float = 8.0
    # die-to-die link energy per bit, by packaging (UCIe white paper [31]:
    # ~0.5 pJ/bit standard (organic) package, 0.25 pJ/bit advanced package)
    e_d2d_pj_bit: tuple = (0.50, 0.25, 0.25)
    # on-package router traversal per bit per hop
    e_router_pj_bit: float = 0.10

    # --- area (mm^2) @ 28nm ----------------------------------------------
    a_pe: float = 0.0015                  # MAC + operand regs + pipeline
    a_sram_per_mb: float = 2.0            # 6T SRAM macro incl. periphery
    a_router: float = 0.25                # in-chiplet NoC router
    a_core_overhead: float = 0.05         # per-core control/misc
    a_chiplet_overhead: float = 1.0       # per-chiplet phy/ctrl floor

    # --- bandwidth --------------------------------------------------------
    # bandwidth density GB/s per mm^2 of die edge I/O area, by packaging.
    # UCIe [31]: advanced package ~6x the density of standard (paper Sec. II-B:
    # interposer has 6x interconnect density vs organic substrate).
    bw_density: tuple = (30.0, 180.0, 180.0)
    # feasible per-link bandwidth cap, by packaging (GB/s)
    link_bw_cap: tuple = (32.0, 256.0, 256.0)
    # per-link bump/lane count multiplier used for the I/O area reservation
    n_link_io: tuple = (1.0, 1.0, 0.5)    # active interposer: routers in the
                                          # interposer -> only 2 of the links
                                          # per chiplet cross bumps (Sec IV-B)
    dram_bw: float = 128.0                # boundary DRAM controller bandwidth
    core_buf_bw: float = 64.0             # core SRAM buffer bandwidth GB/s
    chip_buf_bw: float = 256.0            # chiplet SRAM buffer bandwidth GB/s
    chip_noc_bw: float = 128.0            # intra-chiplet core<->buffer NoC

    # --- fabrication cost (Eq. 1) ------------------------------------------
    wafer_diameter_mm: float = 300.0
    wafer_cost: float = 3500.0            # 28nm processed wafer, USD
    defect_density_mm2: float = 0.0009    # D0 = 0.09 /cm^2  (28nm mature)
    yield_alpha: float = 4.0              # negative-binomial clustering alpha
    scribe_mm: float = 0.2                # die separation margin
    # bonding cost per die: organic / passive / active (microbump attach)
    c_bond: tuple = (1.0, 2.0, 2.0)
    bond_yield: float = 0.99              # per-die bonding success
    # organic substrate cost per mm^2 of package area
    c_substrate_mm2: float = 0.01
    # interposer wafers: passive (metal-only, low defect density) vs active
    # (mature-node CMOS, e.g. 65nm class)
    int_wafer_cost: tuple = (0.0, 900.0, 1500.0)
    int_defect_mm2: tuple = (0.0, 0.0002, 0.0005)
    c_process: float = 5.0                # assembly/test per package
    interposer_margin: float = 1.15       # interposer area vs sum of die area

    # --- calibration correction factors ------------------------------------
    # Per-metric multiplicative corrections applied at the very end of
    # evaluate_arrays.  1.0 is the exact multiplicative identity for every
    # finite float, so the default model stays bit-identical; repro.calib
    # fits them (in log-space) against measured ground truth.
    corr_latency: float = 1.0
    corr_energy: float = 1.0
    corr_area: float = 1.0
    corr_cost: float = 1.0


DEFAULT_TECH = TechConstants()


# ---------------------------------------------------------------------------
# Calibration support: stable identity + serialization + fittable whitelist
# ---------------------------------------------------------------------------

def tech_to_dict(tech: TechConstants) -> dict:
    """Serialize a TechConstants to a JSON-clean dict (tuples -> lists)."""
    out = {}
    for f in dataclasses.fields(tech):
        v = getattr(tech, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def tech_from_dict(d: dict) -> TechConstants:
    """Inverse of :func:`tech_to_dict`.  Unknown keys are rejected loudly;
    missing keys fall back to the field default (forward compatibility for
    artifacts written before a field existed)."""
    names = {f.name for f in dataclasses.fields(TechConstants)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown TechConstants fields: {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(TechConstants):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(f.default, tuple):
            v = tuple(v)
        elif isinstance(f.default, int) and not isinstance(f.default, bool):
            v = int(v) if float(v) == int(v) else float(v)
        else:
            v = float(v)
        kwargs[f.name] = v
    return TechConstants(**kwargs)


def tech_key(tech: TechConstants | None = None) -> str:
    """Stable content digest of a TechConstants.

    This — not ``repr()`` — is the canonical tech identity everywhere one is
    needed (archive/manifest cache keys, provenance, calibrated-preset
    artifacts).  Values are serialized with ``repr(float(...))`` which is
    exact for Python floats, so two structurally-equal instances always share
    a key and any field change (including a fitted correction factor) yields
    a new one.
    """
    tech = DEFAULT_TECH if tech is None else tech
    payload = json.dumps(tech_to_dict(tech), sort_keys=True, separators=(",", ":"),
                         default=repr)
    return hashlib.sha256(payload.encode()).hexdigest()


#: TechConstants fields the calibration fit is allowed to move.  Everything
#: here is a positive scalar (log-space reparameterization assumes > 0 after
#: flooring); integers, tuples and geometry-defining fields stay frozen.
FITTABLE_FIELDS = (
    # timing
    "router_delay_ns", "t_tile_overhead_ns",
    # energy
    "e_mac_pj", "e_reg_pj_bit", "e_core_sram_pj_bit", "e_chip_sram_pj_bit",
    "e_dram_pj_bit", "e_router_pj_bit",
    # area
    "a_pe", "a_sram_per_mb", "a_router", "a_core_overhead",
    "a_chiplet_overhead",
    # bandwidth
    "dram_bw", "core_buf_bw", "chip_buf_bw", "chip_noc_bw",
    # cost
    "wafer_cost", "defect_density_mm2", "c_substrate_mm2", "c_process",
    # per-metric corrections
    "corr_latency", "corr_energy", "corr_area", "corr_cost",
)

#: metric -> fields guaranteed to move that metric on the golden design used
#: by the differentiability regression test (tests/test_torch_calib.py).  The
#: bandwidth fields are fittable but deliberately absent here: latency takes
#: the max over compute/memory passes, so a bandwidth's gradient is non-zero
#: only in the regime where that bandwidth binds (the test exercises one such
#: regime separately).
METRIC_FIELDS = {
    "latency_ns": ("router_delay_ns", "t_tile_overhead_ns", "corr_latency"),
    "energy_pj": ("e_mac_pj", "e_reg_pj_bit", "e_core_sram_pj_bit",
                  "e_chip_sram_pj_bit", "e_dram_pj_bit", "e_router_pj_bit",
                  "corr_energy"),
    "area_mm2": ("a_pe", "a_sram_per_mb", "a_router", "a_core_overhead",
                 "a_chiplet_overhead", "corr_area"),
    "cost_usd": ("wafer_cost", "defect_density_mm2", "c_substrate_mm2",
                 "c_process", "corr_cost"),
}


# ---------------------------------------------------------------------------
# the card the planning layer prices (autosharding advisor, step roofline)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class H100Target:
    """One NVIDIA H100 SXM5 80GB HBM3 at 700 W, from NVIDIA's H100 data
    sheet: dense bf16 tensor-core peak, HBM3 bandwidth, NVLink 4 (18 links
    of 25 GB/s a direction), device memory, and shared memory an SM.  The
    counterpart of the reference's ``TPUTarget``; a field takes any value,
    so a test can hand it the reference target's numbers.

    Collectives are priced on two tiers: a group inside one node of
    ``node_gpus`` cards on NVLink, ``links_per_chip * link_gbps``; a group
    that spans nodes on the network between them, ``net_gbps`` a card a
    direction (NVIDIA's DGX H100 data sheet: eight 400 Gb/s ConnectX-7
    ports a node of 8 GPUs, 50 GB/s a GPU).  ``node_gpus`` at least the
    mesh size prices one fabric, as the reference prices its torus."""
    peak_bf16_tflops: float = 989.4       # dense, per card
    hbm_gbps: float = 3350.0              # per card
    link_gbps: float = 25.0               # per NVLink link per direction
    links_per_chip: int = 18
    hbm_bytes: float = 80e9               # capacity per card
    smem_bytes: float = 228 * 2**10       # shared memory per SM
    node_gpus: int = 8                    # cards on one NVLink fabric
    net_gbps: float = 50.0                # between nodes, a card a direction


DEFAULT_H100 = H100Target()
