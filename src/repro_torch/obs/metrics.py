"""Process-wide metrics registry: counters, gauges, and reservoir
histograms with exact quantiles.

Dependency-free (stdlib + optional numpy only at call sites) and
thread-safe: the exploration benchmarks run service queries on
background threads, so every mutation takes the registry's lock.  The
registry is a flat namespace of dotted metric names — the catalog the
search stack emits is documented in the README's "Observability"
section (``explore.cache.hit``, ``explore.evals.spent``, ...).

Histograms keep a *bounded reservoir* of observations: quantiles are
EXACT while the observation count stays within the reservoir capacity
(the common case — a session observes hundreds of segments, not
millions), and degrade to uniform reservoir sampling (Algorithm R with
a deterministic per-histogram PRNG) beyond it, so memory stays bounded
however long a service lives.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple


class Counter:
    """Monotone event counter (``inc`` only)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> "Counter":
        with self._lock:
            self.value += int(n)
        return self


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> "Gauge":
        with self._lock:
            self.value = float(v)
        return self


class Histogram:
    """Bounded-reservoir distribution of float observations.

    ``quantile(q)`` is exact (a sorted-order statistic over everything
    observed) while ``count <= capacity``; past that the reservoir is a
    uniform sample (Algorithm R) and quantiles are estimates over it.
    The per-histogram PRNG is seeded from the metric name, so a re-run
    of the same workload reproduces the same reservoir."""

    __slots__ = ("name", "capacity", "count", "total", "vmin", "vmax",
                 "_res", "_rng", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 capacity: int = 1024):
        self.name = name
        self.capacity = max(int(capacity), 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._res: List[float] = []
        self._rng = random.Random(name)
        self._lock = lock

    def observe(self, v: float) -> "Histogram":
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            if len(self._res) < self.capacity:
                self._res.append(v)
            else:                        # Algorithm R: keep a uniform
                j = self._rng.randrange(self.count)     # sample of size
                if j < self.capacity:                   # ``capacity``
                    self._res[j] = v
        return self

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile (0 <= q <= 1) of the reservoir — exact
        while ``count <= capacity``.  ``None`` before any observation."""
        with self._lock:
            if not self._res:
                return None
            s = sorted(self._res)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[max(idx, 0)]

    def quantiles(self, qs: Tuple[float, ...] = (0.5, 0.9, 0.99)
                  ) -> Dict[str, Optional[float]]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None


class MetricsRegistry:
    """One flat, thread-safe namespace of named metrics.  ``counter`` /
    ``gauge`` / ``histogram`` create-or-return (a name is permanently
    bound to its first kind — asking for the same name as a different
    kind is a bug and raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, **kw)
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a "
                            f"{type(m).__name__}, not a {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, capacity: int = 1024) -> Histogram:
        return self._get(name, Histogram, capacity=capacity)

    def peek(self, name: str) -> Optional[object]:
        """The metric registered under ``name``, WITHOUT creating it —
        for read-only consumers (e.g. ``Plan`` wall-clock prediction off
        the segment-time histograms) that must not pollute the namespace
        with empty metrics just by asking."""
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-serializable dump of every metric: counters/gauges carry
        ``value``; histograms carry count/mean/min/max and exact(-ish)
        p50/p90/p99."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict] = {}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out[name] = dict(kind="counter", value=m.value)
            elif isinstance(m, Gauge):
                out[name] = dict(kind="gauge", value=m.value)
            else:
                h: Histogram = m            # type: ignore[assignment]
                out[name] = dict(kind="histogram", count=h.count,
                                 mean=h.mean,
                                 min=h.vmin if h.count else None,
                                 max=h.vmax if h.count else None,
                                 **h.quantiles())
        return out

    def reset(self) -> None:
        """Drop every metric (tests and fresh benchmark arms)."""
        with self._lock:
            self._metrics.clear()


# the process-wide registry every instrumentation site writes into
REGISTRY = MetricsRegistry()

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]
