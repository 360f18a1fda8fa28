"""Straggler mitigation: per-step wall-time EWMA monitor (the reference's
``repro/runtime/straggler.py``).

On a 1000+ node fleet, consistently-slow hosts are the main silent
throughput killer (a synchronous step runs at the speed of the slowest
participant).  The monitor keeps an exponentially-weighted mean/variance of
step times and flags steps slower than ``mean + nsigma * std`` (with a
relative floor) — exactly the signal a fleet controller uses to cordon a
host and trigger an elastic restart without it.  Here the flag is surfaced
to the driver and tested with injected delays."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.1           # EWMA weight
    nsigma: float = 4.0
    rel_floor: float = 1.5       # never flag below 1.5x the mean
    warmup: int = 5              # first steps include compile time

    mean: float = 0.0
    var: float = 0.0
    n: int = 0

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step time; returns True if it is a straggler step."""
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else (
                self.mean + (dt - self.mean) / self.n)
            return False
        flagged = False
        std = math.sqrt(max(self.var, 1e-12))
        if (dt > self.mean + self.nsigma * std
                and dt > self.rel_floor * self.mean):
            flagged = True
        else:
            # only fold non-outliers into the statistics
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return flagged
