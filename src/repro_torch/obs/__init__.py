"""``repro_torch.obs`` — the flight recorder: structured tracing, a process
metrics registry, and crash-safe JSONL run journals.

The port's own copy of ``repro.obs``, with the same metric names, record
types and record keys, so a journal either package writes reads in the
other.  Dependency-free (stdlib + numpy, and torch only to serialize a
tensor) and threaded through the port's search stack
(``repro_torch.explore`` service / api / archive / surrogate).  Spans time
the host: they never synchronize the card.  Three layers:

* ``trace``   — nested wall-clock spans (``span("refine", problem=ck)``),
  the enable/disable switch (a shared no-op singleton when disabled:
  results are bit-identical with observability on or off), and the
  record-sink fan-out journals attach to.
* ``metrics`` — process-wide registry of counters / gauges / bounded
  reservoir histograms with exact p50/p90/p99 (``REGISTRY.snapshot()``).
* ``journal`` — append-only JSONL run journals with atomic line writes,
  keyed by ``Problem.key()``-derived cache keys; one record per span
  close, scan segment, plan, and result.  Enable per session
  (``Session(journal=...)``) or fleet-wide via ``$REPRO_JOURNAL_DIR``.
* ``report``  — the CLI renderer: ``python -m repro_torch.obs.report
  <journal>`` prints plan-vs-actual tables and a fleet summary (hit
  rate, evals/sec, p50/p99 time-to-front).
"""

from .journal import (JOURNAL_ENV, Journal, default_journal,  # noqa: F401
                      read_journal, replay, resolve_journal)
from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry)
from .trace import (NOOP_SPAN, Span, active, add_sink,  # noqa: F401
                    current_run, disable, emit, enable, enabled, gauge,
                    inc, observe, remove_sink, run_context, sink_attached,
                    span)

__all__ = [
    "JOURNAL_ENV", "Journal", "NOOP_SPAN", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "Span", "active", "add_sink",
    "current_run", "default_journal", "disable", "emit", "enable",
    "enabled", "gauge", "inc", "observe", "read_journal", "remove_sink",
    "replay", "resolve_journal", "run_context", "sink_attached", "span",
]
