"""The objective axes every engine agrees on (the part of
``repro.core.optimizer`` the search path needs; the BO x SA engine lands in
this module later).  Functions take a population's metrics dict and return
(P, 4) stacks."""

from __future__ import annotations

from typing import Dict

import torch

F = torch.float32

# the objective axes every engine (scalarized BO x SA, NSGA-II fronts,
# Pareto archives) agrees on, in canonical order
METRIC_KEYS = ("latency_ns", "energy_pj", "cost_usd", "area_mm2")


def metric_stack(metrics: Dict) -> torch.Tensor:
    """(..., 4) raw metric vectors in ``METRIC_KEYS`` order (archive rows)."""
    return torch.stack([metrics[k].to(F) for k in METRIC_KEYS], dim=-1)


def log_metric_stack(metrics: Dict) -> torch.Tensor:
    """(..., 4) clipped log-metric vectors — the shared evaluation path of
    the search engines."""
    return torch.stack([torch.log(metrics[k].to(F).clamp_min(1e-3))
                        for k in METRIC_KEYS], dim=-1)
