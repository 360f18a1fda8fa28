"""``repro_torch.api`` — the front door of the port (re-exports
``repro_torch.explore.api``).

    from repro_torch.api import Problem, Query, Session
    from repro_torch.core.presets import transformer_block

    s = Session()                         # device="cuda"; pass "cpu" to opt out
    r = s.submit(Query(Problem(transformer_block(),
                               objectives=("latency_ns", "cost_usd")),
                       budget=2048))
"""

from .explore.api import (ENGINES, Problem, Provenance,  # noqa: F401
                          Query, Result, SegmentEvent, Session)

__all__ = ["ENGINES", "Problem", "Provenance", "Query", "Result",
           "SegmentEvent", "Session"]
