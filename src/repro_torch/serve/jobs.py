"""Durable job records for the async serving layer (the port's copy of
``repro.serve.jobs``).

A *job* is one ``Query`` a client handed to ``Session.submit_async``:
the problem (serialized well enough to rebuild a bit-identical
``Problem``), the search options, a deterministic PRNG seed, and a state
machine (``PENDING → RUNNING → DONE | FAILED | CANCELLED``).  Jobs live
as one JSON file each under ``<store>/job-<id>.json`` — the *job
journal* — written atomically (tmp + ``os.replace``), so the store is
readable after any crash and a restarted worker can ``recover()`` the
jobs a dead process left RUNNING and run them to completion.  Combined
with the engine's per-segment checkpoint (``run_queries(resume=True)``),
a SIGKILLed job resumes from its last completed scan segment and spends
only the residual budget.

Claiming is lock-arbitrated (``claim`` takes the store-wide file lock),
so many worker processes can drain one store without double-running a
job; ownership is the claimer's PID, and ``recover()`` uses PID
liveness to tell a crashed owner from a busy one.

A record is the reference's JSON, field for field: either package's
``JobStore`` reads a store the other wrote.  The two packages' archive
cache keys differ (the port salts them with ``service.CACHE_SALT``), so a
job is run by the package that submitted it.  Temporary files are named by
process AND thread: a client thread cancelling a job and a worker thread
updating it never share one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core.workload import Edge, TensorRef, Workload, WorkloadGraph
from ..explore.locks import file_lock

PENDING = "PENDING"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TERMINAL = (DONE, FAILED, CANCELLED)


# ---------------------------------------------------------------------------
# problem (de)serialization — enough to rebuild a bit-identical Problem
# ---------------------------------------------------------------------------
def graph_to_json(graph: WorkloadGraph) -> Dict:
    """A ``WorkloadGraph`` as plain JSON: the frozen dataclasses are
    flat (ints, strings, tuples), so a field dump round-trips exactly —
    and exact round-trip is the contract: the rebuilt graph must produce
    the same ``Problem.key()`` or the job would refine a stranger's
    archive."""
    return dict(
        workloads=[dict(
            name=w.name, loops=[[n, b] for n, b in w.loops],
            flops_per_instance=w.flops_per_instance,
            tensors=[dict(name=t.name,
                          dims=[list(g) for g in t.dims],
                          is_output=t.is_output) for t in w.tensors])
            for w in graph.workloads],
        edges=[dict(src=e.src, dst=e.dst, tensor_src=e.tensor_src,
                    tensor_dst=e.tensor_dst) for e in graph.edges])


def graph_from_json(d: Dict) -> WorkloadGraph:
    return WorkloadGraph(
        workloads=[Workload(
            name=w["name"],
            loops=tuple((n, int(b)) for n, b in w["loops"]),
            tensors=tuple(TensorRef(t["name"],
                                    tuple(tuple(g) for g in t["dims"]),
                                    t["is_output"])
                          for t in w["tensors"]),
            flops_per_instance=w["flops_per_instance"])
            for w in d["workloads"]],
        edges=[Edge(e["src"], e["dst"], e["tensor_src"],
                    e["tensor_dst"]) for e in d["edges"]])


@dataclasses.dataclass
class JobRecord:
    """One durable job.  ``payload`` is the serialized query (graph,
    objectives, space bounds, budget, engine options); ``seed`` fixes
    the PRNG chain so every attempt — first run, crash resume, cross-
    process reconstruction — draws identical keys.  ``attempts`` counts
    claims; ``n_evals_attempts`` the evaluations each attempt actually
    spent (the resume-overhead ledger: a perfect resume's attempts sum
    to the uninterrupted run's spend)."""
    job_id: str
    state: str
    payload: Dict
    problem_key: str                # Problem.key() — the job-journal key
    cache_key: str                  # tech-folded archive identity; the
    #                                 worker asserts its session derives
    #                                 the same one (tech mismatch = the
    #                                 wrong archive entirely)
    seed: int
    created_t: float
    updated_t: float = 0.0
    owner_pid: Optional[int] = None
    attempts: int = 0
    n_evals_attempts: List[int] = dataclasses.field(default_factory=list)
    elapsed_attempts: List[float] = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "JobRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _pid_alive(pid: Optional[int]) -> bool:
    if pid is None:
        return False
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:         # exists, owned by someone else
        return True
    except OSError:
        return False


class JobStore:
    """The on-disk job journal: one atomically-written JSON file per
    job under ``root``, plus a store-wide file lock arbitrating claims.

    Every read is from disk (job files are small and the store is the
    cross-process source of truth); every write goes through tmp +
    ``os.replace``.  ``claim`` is the only compound operation: under the
    lock it re-reads the record, verifies it is still claimable, and
    flips it to RUNNING owned by this PID — two workers draining one
    store can never both win a job."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = self.root / "store.lock"

    # ---- paths ----------------------------------------------------------
    def _path(self, job_id: str) -> Path:
        return self.root / f"job-{job_id}.json"

    # ---- CRUD -----------------------------------------------------------
    def create(self, payload: Dict, problem_key: str, cache_key: str,
               seed: int) -> JobRecord:
        rec = JobRecord(
            job_id=uuid.uuid4().hex[:12], state=PENDING, payload=payload,
            problem_key=problem_key, cache_key=cache_key, seed=int(seed),
            created_t=time.time(), updated_t=time.time())
        self._write(rec)
        return rec

    def get(self, job_id: str) -> Optional[JobRecord]:
        p = self._path(job_id)
        try:
            return JobRecord.from_json(json.loads(p.read_text()))
        except FileNotFoundError:
            return None
        except Exception as e:      # a torn record is unreachable, not
            warnings.warn(f"unreadable job record {p}: {e}")    # fatal
            return None

    def _write(self, rec: JobRecord) -> None:
        rec.updated_t = time.time()
        p = self._path(rec.job_id)
        tmp = p.with_name(
            f".{p.name}.tmp{os.getpid()}.{threading.get_ident()}")
        try:
            tmp.write_text(json.dumps(rec.to_json()))
            os.replace(tmp, p)
        finally:
            tmp.unlink(missing_ok=True)

    def update(self, rec: JobRecord, **fields) -> JobRecord:
        for k, v in fields.items():
            setattr(rec, k, v)
        self._write(rec)
        return rec

    def jobs(self) -> List[JobRecord]:
        out = []
        for p in sorted(self.root.glob("job-*.json")):
            rec = self.get(p.stem[len("job-"):])
            if rec is not None:
                out.append(rec)
        return out

    def pending(self) -> List[JobRecord]:
        """Claimable jobs, oldest first (FIFO admission)."""
        return sorted((r for r in self.jobs() if r.state == PENDING),
                      key=lambda r: r.created_t)

    # ---- the compound ops (lock-arbitrated) -----------------------------
    def claim(self, job_id: str) -> Optional[JobRecord]:
        """Atomically take ownership of one PENDING job: under the store
        lock, re-read, verify claimable, flip to RUNNING owned by this
        PID.  ``None`` when someone else won (or the job advanced)."""
        with file_lock(self._lock):
            rec = self.get(job_id)
            if rec is None or rec.state != PENDING:
                return None
            rec.state = RUNNING
            rec.owner_pid = os.getpid()
            rec.attempts += 1
            self._write(rec)
            return rec

    def recover(self) -> Tuple[JobRecord, ...]:
        """Flip RUNNING jobs whose owner PID is dead back to PENDING —
        the crash-recovery sweep a (re)starting worker runs before
        draining.  The engine checkpoint those jobs left behind makes
        the re-run a resume, not a restart."""
        recovered = []
        with file_lock(self._lock):
            for rec in self.jobs():
                if rec.state == RUNNING and not _pid_alive(rec.owner_pid):
                    rec.state = PENDING
                    rec.owner_pid = None
                    self._write(rec)
                    recovered.append(rec)
        return tuple(recovered)


__all__ = ["CANCELLED", "DONE", "FAILED", "JobRecord", "JobStore",
           "PENDING", "RUNNING", "TERMINAL", "graph_from_json",
           "graph_to_json"]
