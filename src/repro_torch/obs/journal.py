"""Crash-safe JSONL run journals: the persistent half of the flight
recorder.

A ``Journal`` is an append-only ``.jsonl`` file of one JSON record per
line.  Writes are *atomic at line granularity*: each record is a single
``os.write`` to an ``O_APPEND`` descriptor, so concurrent writers (the
benchmark suite runs service queries on background threads) interleave
whole lines and a crash mid-run leaves at worst one truncated final
line — which ``read_journal`` tolerates and skips.  The journal is
opened lazily on the first record, so configuring one costs nothing
until something is actually observed.

Record vocabulary (all records carry ``t`` wall-clock seconds, and the
run-scoped ones carry ``key`` — the ``Problem.key()``-derived archive
cache key):

* ``plan``    — what ``Session.submit`` is about to do for one query:
  engine, budget, cache verdict, the quantized ``SegmentPlan`` schedule
  and predicted transfer neighbors.
* ``segment`` — one closed scan segment: phase (``refine``/``realloc``),
  per-phase segment index, stream-monotone ``seq``, wall-clock
  ``elapsed_s``, evaluations, archive-projected hypervolume row, and
  ``compile`` marking the first execution of that runner variant in the
  process (in the port: the one that loads the kernel libraries, creates
  the CUDA context and warms the caches; in the reference: XLA lowering).
* ``result``  — one finished query: provenance accounting + final
  hypervolume / front size + ``elapsed_s`` (time-to-front).
* ``span`` / ``metrics`` / ``callback_error`` — tracing spans, registry
  snapshots, and dropped ``on_segment`` deliveries.

``replay`` folds a record stream back into per-key run summaries — the
completeness check ``benchmarks.bench_obs`` gates on (journal segment
count and final hypervolume must match the in-memory ``Result``).

Enable journaling per session (``Session(journal=...)``) or fleet-wide
via ``$REPRO_JOURNAL_DIR`` — ``default_journal()`` lazily creates one
process-wide journal file inside that directory.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

JOURNAL_ENV = "REPRO_JOURNAL_DIR"


def _json_default(o):
    """Serialize the numpy and torch scalars/arrays that ride in trace
    records: a 0-d tensor becomes a Python number, any other tensor a
    (nested) list, read back to the host."""
    import numpy as np
    import torch
    if isinstance(o, torch.Tensor):
        o = o.detach().cpu()
        return o.item() if o.dim() == 0 else o.tolist()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    if isinstance(o, (set, tuple)):
        return list(o)
    return str(o)


class Journal:
    """Append-only JSONL journal with atomic line writes.

    ``write(record)`` stamps ``t`` (wall clock) and appends one line;
    the file descriptor is opened ``O_APPEND`` on first use and every
    record is one ``write(2)`` call, so lines are never interleaved or
    half-flushed through Python buffering.  ``fsync=True`` additionally
    syncs every line — crash-safe against power loss, at a per-record
    cost (the default relies on the kernel page cache, which survives
    process crashes, the case the run journal is for)."""

    def __init__(self, path, fsync: bool = False):
        self.path = Path(path)
        self.fsync = bool(fsync)
        self._fd: Optional[int] = None
        self._lock = threading.Lock()

    def _ensure_open(self) -> int:
        if self._fd is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fd = os.open(
                str(self.path),
                os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        return self._fd

    def write(self, record: Dict) -> None:
        rec = dict(record)
        rec.setdefault("t", time.time())
        line = json.dumps(rec, default=_json_default,
                          separators=(",", ":")) + "\n"
        data = line.encode()
        with self._lock:
            fd = self._ensure_open()
            os.write(fd, data)
            if self.fsync:
                os.fsync(fd)

    # journals ARE record sinks: ``obs.trace.emit`` calls each attached
    # sink as ``sink(record)``
    def __call__(self, record: Dict) -> None:
        self.write(record)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def records(self) -> List[Dict]:
        return list(read_journal(self.path))


# ---------------------------------------------------------------------------
# reading + replay
# ---------------------------------------------------------------------------
def read_journal(path) -> Iterator[Dict]:
    """Yield the records of one journal file (or every ``*.jsonl`` under
    a directory, in name order).  Unparseable MID-FILE lines — foreign
    garbage, a corrupted record — are skipped with one summary warning,
    never fatal: a journal must be readable after any crash.  A partial
    FINAL line that the file does not terminate with a newline is
    skipped silently: that is the normal in-flight write of a live
    appender (or the truncated tail of a crash), not damage — readers
    polling a journal a writer is still appending to must not warn on
    every poll."""
    path = Path(path)
    files = sorted(path.glob("*.jsonl")) if path.is_dir() else [path]
    bad = 0
    for f in files:
        try:
            text = f.read_text()
        except OSError as e:
            warnings.warn(f"unreadable journal {f}: {e}")
            continue
        lines = text.split("\n")
        live_tail = lines.pop() if lines else ""    # "" when the file
        #                                 ends in \n; else an in-flight
        #                                 or truncated final line
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                yield rec
            else:
                bad += 1
        live_tail = live_tail.strip()
        if live_tail:                   # salvage a complete-but-unflushed
            try:                        # record; else drop it silently
                rec = json.loads(live_tail)
                if isinstance(rec, dict):
                    yield rec
            except json.JSONDecodeError:
                pass
    if bad:
        warnings.warn(f"journal {path}: skipped {bad} unparseable "
                      f"line(s)")


def _replay_slot() -> Dict:
    return dict(segments=0, segments_by_phase={}, n_evals=0,
                final_hv=None, hv_path=[], results=[], plans=[],
                planned_segments=0, elapsed_s=0.0)


def replay(records: Union[Sequence[Dict], Iterator[Dict]]) -> Dict[str, Dict]:
    """Fold a record stream into per-key run summaries:

    ``{key: {segments, segments_by_phase, n_evals, final_hv, hv_path,
    results, planned_segments, plans, elapsed_s, runs}}``

    Records are PARTITIONED by the ``run`` stamp each submission's
    ``obs.run_context`` put on them (records without one share a single
    legacy partition), not by record order: overlapping submissions
    interleave their records in a shared fleet journal, so order-based
    attribution would splice one run's segments into another's.  Each
    partition is summarized independently under ``runs[run_id]``; the
    per-key top level aggregates them — counters sum, ``results`` /
    ``plans`` concatenate (partition-ordered), while ``final_hv`` /
    ``hv_path`` come from the run with the LATEST record (a hypervolume
    trajectory only means something within one run; summing two runs'
    paths would fabricate a trajectory nobody searched).  With a single
    run in the journal the aggregate equals the partition, so
    single-submission consumers are unchanged.

    ``segments`` counts every segment record of the key (all phases);
    ``final_hv`` is the first column of the last segment's
    archive-projected hypervolume row (the quantity the plateau detector
    monitors and ``ConvergenceTrace.archive_hv`` carries in memory) —
    the invariant ``bench_obs`` replays against the in-memory result."""
    out: Dict[str, Dict] = {}
    last_t: Dict[str, Dict] = {}

    def slot(key: str, run) -> Dict:
        k = out.setdefault(key, dict(_replay_slot(), runs={}))
        if run not in k["runs"]:
            k["runs"][run] = _replay_slot()
            last_t.setdefault(key, {})[run] = float("-inf")
        return k["runs"][run]

    for rec in records:
        key = rec.get("key")
        typ = rec.get("type")
        if key is None:
            continue
        run = rec.get("run")
        if typ in ("segment", "result", "plan"):
            s = slot(key, run)
            last_t[key][run] = max(last_t[key][run],
                                   float(rec.get("t", 0.0)))
        if typ == "segment":
            s["segments"] += 1
            ph = rec.get("phase", "refine")
            s["segments_by_phase"][ph] = \
                s["segments_by_phase"].get(ph, 0) + 1
            s["n_evals"] += int(rec.get("n_evals", 0))
            s["elapsed_s"] += float(rec.get("elapsed_s", 0.0))
            hv = rec.get("hv")
            if hv:
                s["hv_path"].append(float(hv[0]))
                s["final_hv"] = float(hv[0])
        elif typ == "result":
            s["results"].append(rec)
        elif typ == "plan":
            s["plans"].append(rec)
            s["planned_segments"] += len(rec.get("segments", ()))
    for key, k in out.items():
        for run, s in k["runs"].items():
            k["segments"] += s["segments"]
            for ph, n in s["segments_by_phase"].items():
                k["segments_by_phase"][ph] = \
                    k["segments_by_phase"].get(ph, 0) + n
            k["n_evals"] += s["n_evals"]
            k["elapsed_s"] += s["elapsed_s"]
            k["planned_segments"] += s["planned_segments"]
            k["results"].extend(s["results"])
            k["plans"].extend(s["plans"])
        with_hv = [r for r, s in k["runs"].items()
                   if s["final_hv"] is not None]
        if with_hv:
            latest = max(with_hv, key=lambda r: last_t[key][r])
            k["final_hv"] = k["runs"][latest]["final_hv"]
            k["hv_path"] = list(k["runs"][latest]["hv_path"])
    return out


# ---------------------------------------------------------------------------
# the process-wide env-configured default journal
# ---------------------------------------------------------------------------
_DEFAULT: Optional[Journal] = None
_DEFAULT_LOCK = threading.Lock()


def default_journal() -> Optional[Journal]:
    """The process-wide journal ``$REPRO_JOURNAL_DIR`` configures, or
    ``None`` when the env var is unset.  One file per process
    (``run-<timestamp>-<pid>.jsonl``), created lazily on first write —
    every ``Session`` without an explicit ``journal=`` shares it, so a
    benchmark run lands in one journal however many sessions it opens."""
    global _DEFAULT
    root = os.environ.get(JOURNAL_ENV)
    if not root:
        return None
    with _DEFAULT_LOCK:
        if _DEFAULT is None or Path(root) != _DEFAULT.path.parent:
            stamp = time.strftime("%Y%m%d-%H%M%S")
            _DEFAULT = Journal(
                Path(root) / f"run-{stamp}-{os.getpid()}.jsonl")
    return _DEFAULT


def resolve_journal(journal) -> Optional[Journal]:
    """Normalize a ``Session(journal=...)`` argument: a ``Journal`` is
    used as-is, a path-like creates one there, ``None`` falls back to
    the ``$REPRO_JOURNAL_DIR`` default journal (or no journal at all),
    and ``False`` explicitly disables journaling for the session even
    when the env var is set."""
    if journal is False:
        return None
    if journal is None:
        return default_journal()
    if isinstance(journal, Journal):
        return journal
    return Journal(journal)


__all__ = ["JOURNAL_ENV", "Journal", "default_journal", "read_journal",
           "replay", "resolve_journal"]
