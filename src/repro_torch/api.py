"""``repro_torch.api`` — the front door of the port (re-exports
``repro_torch.explore.api``).

    from repro_torch.api import Problem, Query, Session
    from repro_torch.core.presets import transformer_block

    s = Session()                         # device="cuda"; pass "cpu" to opt out
    r = s.submit(Query(Problem(transformer_block(),
                               objectives=("latency_ns", "cost_usd")),
                       budget=2048))
    s.plan(Query(..., transfer=True))     # neighbors and seed quotas first
    h = s.submit_async(Query(...))        # a serve.JobHandle; h.result()
"""

from .explore.api import (ENGINES, NeighborPlan, Plan,  # noqa: F401
                          Problem, Provenance, Query, Result, SegmentEvent,
                          SegmentPlan, Session, plan, session, submit)
from .explore.service import RunControl  # noqa: F401

__all__ = ["ENGINES", "NeighborPlan", "Plan", "Problem", "Provenance",
           "Query", "Result", "RunControl", "SegmentEvent", "SegmentPlan",
           "Session", "plan", "session", "submit"]
