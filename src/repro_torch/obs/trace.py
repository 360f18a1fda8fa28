"""Tracing core: nested wall-clock spans, the enable/disable switch, and
the record-sink fan-out that feeds run journals.

The contract the instrumented search stack relies on:

* ``span("refine", problem=ck)`` is a context manager measuring
  monotonic wall-clock; spans nest (a thread-local stack tracks depth
  and parent), and every close feeds a ``span.<name>`` histogram in the
  process-wide metrics registry plus — when a journal is attached — one
  ``span`` record.
* **Zero cost when disabled**: ``disable()`` flips one module-level
  flag; ``span(...)`` then returns a shared no-op singleton and
  ``inc``/``observe``/``emit`` return immediately.  Instrumentation
  never touches PRNG keys or numeric state, so results are bit-identical
  with observability on or off — disabling only removes the clock reads.
* ``emit(record)`` fans a dict record out to the attached sinks (the
  crash-safe JSONL journals of ``repro_torch.obs.journal``); ``add_sink`` /
  ``remove_sink`` / the ``sink_attached`` context manager manage the
  active set.  ``active()`` is the cheap "is anyone listening" check
  call sites use before assembling a record.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

from .metrics import REGISTRY

_ENABLED = True
_SINKS: List[Callable[[Dict], None]] = []
_SINK_LOCK = threading.Lock()
# sink -> live sink_attached count.  Keyed by the sink itself (not id):
# bound methods compare and hash by (self, func), so two accesses of the
# same `journal.write` count as one attachment, matching add_sink's
# equality check.
_SINK_REFS: Dict[Callable[[Dict], None], int] = {}
_TLS = threading.local()


def enable() -> None:
    """Turn instrumentation on (the default)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn instrumentation off: spans become a shared no-op, metric and
    record emission return immediately."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def active() -> bool:
    """True when a record sink (journal) is attached AND instrumentation
    is enabled — the guard for any work done only to build records."""
    return _ENABLED and bool(_SINKS)


# ---------------------------------------------------------------------------
# record sinks (journals attach here)
# ---------------------------------------------------------------------------
def add_sink(sink: Callable[[Dict], None]) -> None:
    if sink not in _SINKS:
        _SINKS.append(sink)


def remove_sink(sink: Callable[[Dict], None]) -> None:
    try:
        _SINKS.remove(sink)
    except ValueError:
        pass


@contextlib.contextmanager
def sink_attached(sink: Optional[Callable[[Dict], None]]):
    """Attach one sink for the duration of a ``with`` block (``None`` is
    a no-op — callers pass their maybe-configured journal straight in).
    Attachment is REFERENCE-COUNTED per sink, so the block is safe to
    nest AND to overlap across threads: two concurrent submissions
    sharing one fleet journal (``$REPRO_JOURNAL_DIR``) each hold a
    reference, and the journal detaches only when the last one exits —
    the first submission finishing must not silence the one still
    running."""
    if sink is None:
        yield
        return
    with _SINK_LOCK:
        _SINK_REFS[sink] = _SINK_REFS.get(sink, 0) + 1
        add_sink(sink)
    try:
        yield
    finally:
        with _SINK_LOCK:
            n = _SINK_REFS.get(sink, 1) - 1
            if n <= 0:
                _SINK_REFS.pop(sink, None)
                remove_sink(sink)
            else:
                _SINK_REFS[sink] = n


# ---------------------------------------------------------------------------
# run identity: which submission a record belongs to
# ---------------------------------------------------------------------------
def current_run() -> Optional[str]:
    """The run id records emitted by THIS thread are stamped with, or
    ``None`` outside any ``run_context``."""
    return getattr(_TLS, "run", None)


@contextlib.contextmanager
def run_context(run_id: Optional[str]):
    """Stamp every record this thread emits with ``run=run_id`` for the
    duration of the block (``None`` is a no-op).  Thread-local, so
    overlapping submissions sharing one fleet journal each stamp their
    own records — ``replay()`` partitions on the stamp instead of
    guessing from record order.  Nests: the innermost context wins
    (records of a sub-operation belong to the run that issued it)."""
    if run_id is None:
        yield
        return
    prev = getattr(_TLS, "run", None)
    _TLS.run = str(run_id)
    try:
        yield
    finally:
        _TLS.run = prev


def emit(record: Dict) -> None:
    """Fan one record out to every attached sink, stamped with the
    thread's current run id (see ``run_context``) when one is set and
    the record doesn't carry its own.  A sink failure is contained
    (observability must never fail the work it observes): the sink is
    dropped for the rest of the run and an ``obs.sink_errors`` counter
    records the loss."""
    if not _ENABLED or not _SINKS:
        return
    run = getattr(_TLS, "run", None)
    if run is not None and "run" not in record:
        record = dict(record, run=run)
    for sink in list(_SINKS):
        try:
            sink(record)
        except Exception:
            remove_sink(sink)
            REGISTRY.counter("obs.sink_errors").inc()


# ---------------------------------------------------------------------------
# metric conveniences (gated on the enable flag)
# ---------------------------------------------------------------------------
def inc(name: str, n: int = 1) -> None:
    if _ENABLED:
        REGISTRY.counter(name).inc(n)


def observe(name: str, v: float) -> None:
    if _ENABLED:
        REGISTRY.histogram(name).observe(v)


def gauge(name: str, v: float) -> None:
    if _ENABLED:
        REGISTRY.gauge(name).set(v)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
def _stack() -> List[str]:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


class Span:
    """One live span: monotonic start on ``__enter__``; on ``__exit__``
    the duration lands in the ``span.<name>`` histogram and (when a
    journal is attached) one ``span`` record with the span's attrs,
    depth, and parent span name.  ``set(**attrs)`` adds attributes to a
    live span (e.g. an outcome computed mid-block)."""

    __slots__ = ("name", "attrs", "t0", "elapsed_s")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.elapsed_s = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        _stack().append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed_s = time.perf_counter() - self.t0
        stack = _stack()
        stack.pop()
        REGISTRY.histogram(f"span.{self.name}").observe(self.elapsed_s)
        if _SINKS:
            rec = dict(type="span", name=self.name,
                       elapsed_s=self.elapsed_s, depth=len(stack),
                       parent=stack[-1] if stack else None)
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            if self.attrs:
                rec["attrs"] = self.attrs
            emit(rec)
        return False


class _NoopSpan:
    """The disabled-mode singleton: every method is a constant-time
    no-op, so an instrumented hot path costs one flag check."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


def span(name: str, **attrs):
    """Open a nested wall-clock span (context manager).  Returns the
    shared no-op singleton when instrumentation is disabled."""
    if not _ENABLED:
        return NOOP_SPAN
    return Span(name, attrs)


__all__ = ["NOOP_SPAN", "Span", "active", "add_sink", "current_run",
           "disable", "emit", "enable", "enabled", "gauge", "inc",
           "observe", "remove_sink", "run_context", "sink_attached",
           "span"]
