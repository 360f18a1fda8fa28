"""Fabrication cost model — paper Eq. (1), the port of ``repro.core.cost``:

    C_total = sum_i ( C_die^i / y_die^i + C_bond ) + C_sub + C_int / y_int + C_proc

Die cost from wafer price / dies-per-wafer; yield from the negative-binomial
model  y = (1 + A * D0 / alpha)^(-alpha).  The substrate cost is proportional
to package area; the interposer is fabricated and yielded like a die.
"""

from __future__ import annotations

import math

import torch

from .constants import DEFAULT_TECH, PKG_ORGANIC, TechConstants
from .energy import tech_table

F = torch.float32


def die_yield(area_mm2, d0_mm2, alpha):
    return (1.0 + area_mm2 * d0_mm2 / alpha) ** (-alpha)


def dies_per_wafer(area_mm2, tech: TechConstants = DEFAULT_TECH):
    """Classic dies-per-wafer approximation with scribe margin."""
    d = tech.wafer_diameter_mm
    a = area_mm2 + tech.scribe_mm * torch.sqrt(area_mm2.clamp_min(1e-6))
    return (math.pi * (d / 2.0) ** 2 / a
            - math.pi * d / torch.sqrt(2.0 * a)).clamp_min(1.0)


def die_cost(area_mm2, tech: TechConstants = DEFAULT_TECH):
    c = tech.wafer_cost / dies_per_wafer(area_mm2, tech)
    y = die_yield(area_mm2, tech.defect_density_mm2, tech.yield_alpha)
    return c / y


def package_cost(die_areas_mm2, packaging, tech: TechConstants = DEFAULT_TECH):
    """Eq. (1) for packages of dies under a packaging technology.

    die_areas_mm2: (P, N) float32 (0 entries = unused slots).
    packaging: (P,) int64, 0 organic / 1 passive / 2 active interposer.
    """
    areas = die_areas_mm2.to(F)
    dev = areas.device
    used = areas > 0.0
    n_dies = used.to(F).sum(-1)
    dies = torch.where(used, die_cost(areas.clamp_min(1e-3), tech), 0.0)
    bond = tech_table(tech.c_bond, dev)[packaging] / tech.bond_yield
    c_dies = dies.sum(-1) + n_dies * bond

    pkg_area = areas.sum(-1) * tech.interposer_margin
    c_sub = pkg_area * tech.c_substrate_mm2

    int_wafer = tech_table(tech.int_wafer_cost, dev)[packaging]
    int_d0 = tech_table(tech.int_defect_mm2, dev)[packaging]
    c_int_raw = int_wafer / dies_per_wafer(pkg_area.clamp_min(1.0), tech)
    y_int = die_yield(pkg_area, int_d0, tech.yield_alpha)
    has_int = (packaging != PKG_ORGANIC).to(F)
    c_int = has_int * c_int_raw / y_int.clamp_min(1e-3)

    return c_dies + c_sub + c_int + tech.c_process


def monolithic_cost(total_area_mm2, tech: TechConstants = DEFAULT_TECH):
    """Baseline: one big die of the same total area + cheap substrate, in
    float32 on the device of ``total_area_mm2`` (a tensor; a number or an
    array goes to the CPU)."""
    a = torch.as_tensor(total_area_mm2).to(F)
    return (die_cost(a, tech) + a * tech.interposer_margin
            * tech.c_substrate_mm2 + tech.c_process)
