"""The in-process async serving layer: ``JobHandle`` + ``Executor`` (the
port's copy of ``repro.serve.executor``).

``Executor.submit(query)`` returns a ``JobHandle`` immediately and runs
the search on a worker-thread pool.  Each worker thread owns a
``Session.clone()`` (services are single-threaded by design), so the
shared cache directory — file-lock-arbitrated manifest and archive
writes — is the only coordination point between workers, exactly as it
is between separate worker *processes* draining the same ``JobStore``.

Durability: every submission lands in the job store before any work is
scheduled, and workers run it with ``resume=True`` (per-segment engine
checkpoints).  Kill the process mid-run and a restarted executor's
``resume_pending()`` (or the ``repro_torch.serve.worker`` CLI) recovers the
job and resumes from the last completed scan segment, spending only the
residual budget and converging to the bit-identical final front.

Admission control: at most ``max_pending`` jobs are in flight.  Past
that, ``submit`` waits up to ``deadline_s`` for a slot and then
*degrades gracefully* — a query whose archive already holds ANY front is
answered immediately with that possibly-stale front
(``provenance.stale=True``, zero evaluations) while the refinement stays
banked as a PENDING job in the store; a cold query (nothing cached to
serve) is queued anyway, since degrading it would return nothing.

On the card, the worker threads share one CUDA context and its default
stream: each clone owns its service, archives and generators, so no tensor
crosses threads, and the kernels' builds, loads and launch counters are
thread-safe (``kernels/build.py``, ``kernels/launch.py``).  A job's seed is
the integer the port's ``Session.submit`` takes.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from .. import obs
from ..core.optimizer import METRIC_KEYS
from ..explore.api import Problem, Provenance, Query, Result
from ..explore.archive import pareto_front
from ..explore.locks import file_lock
from ..explore.service import RunControl, SegmentEvent
from . import jobs
from .jobs import JobRecord, JobStore, graph_from_json, graph_to_json


class CancelledError(RuntimeError):
    """Raised by ``JobHandle.result()`` when the job was cancelled."""


# ---------------------------------------------------------------------------
# query (de)serialization
# ---------------------------------------------------------------------------
def query_to_payload(query: Query) -> Dict:
    """Serialize a ``Query`` for the durable job store.  Only the
    JSON-clean subset is supported: ``seed_designs`` / ``archive`` /
    ``engine_opts`` / ``policy`` carry live numpy or config objects that
    do not round-trip a crash, so async submission rejects them loudly
    rather than dropping them silently.  The dict is the reference's for
    the same query."""
    if query.seed_designs or query.archive is not None \
            or query.engine_opts or query.policy is not None:
        raise ValueError(
            "submit_async supports problem/budget/engine/transfer/"
            "weights queries only; seed_designs / archive / engine_opts "
            "/ policy do not survive the durable job store — use "
            "Session.submit for those")
    if query.tech is not None and not isinstance(query.tech, str):
        raise ValueError(
            "async queries carry tech by NAME (a preset registered via "
            "repro_torch.calib or reachable through $REPRO_CALIB_DIR) so "
            "the worker process can resolve the same constants; pass "
            "tech='<preset>' or use Session.submit for a raw "
            "TechConstants")
    p = query.problem
    return dict(
        graph=graph_to_json(p.graph), objectives=list(p.objectives),
        ch_max=p.ch_max, space_kwargs=dict(p.space_kwargs),
        budget=int(query.budget), engine=query.engine,
        transfer=bool(query.transfer),
        weights=list(query.weights) if query.weights is not None
        else None,
        tech=query.tech)


def query_from_payload(d: Dict) -> Query:
    # JSON turned tuples into lists; the constraint kwargs must come
    # back hashable (they feed the compiled-runner cache key)
    sk = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d["space_kwargs"].items()}
    problem = Problem(graph_from_json(d["graph"]),
                      objectives=tuple(d["objectives"]),
                      ch_max=int(d["ch_max"]), space_kwargs=sk)
    return Query(problem, budget=int(d["budget"]), engine=d["engine"],
                 transfer=bool(d["transfer"]),
                 weights=tuple(d["weights"]) if d.get("weights")
                 is not None else None,
                 tech=d.get("tech"))


def stale_result(session, query: Query, cache_key: str,
                 max_age_s: Optional[float] = None) -> Optional[Result]:
    """The degradation answer: the freshest cached front for the query's
    problem, straight off the shared archive (disk state merged in
    first — another service may have refined it since we last looked),
    re-projected to the query's objectives.  ``None`` when the archive
    is empty — a cold problem has nothing to degrade to.  Costs zero
    evaluations; ``provenance.stale=True`` and the query's whole budget
    shows as banked (the refinement debt the job store still owes).

    ``max_age_s`` bounds how old a served front may be: when the
    archive npz on disk was last refined more than ``max_age_s`` seconds
    ago, the front is TOO stale to degrade to and ``None`` is returned
    (the caller queues the refinement instead).  An archive that exists
    only in this process's memory (no npz yet) is by construction
    current and always serves."""
    p = query.problem
    t0 = time.perf_counter()
    arc = session.service.refresh_archive(p.spec, p.space, key=cache_key)
    if len(arc) == 0:
        return None
    if max_age_s is not None:
        try:
            age = time.time() - session.service._path(cache_key) \
                .stat().st_mtime
        except OSError:
            age = 0.0       # in-memory only: refined by THIS process
        if age > max_age_s:
            obs.inc("serve.stale_expired")
            return None
    designs, metrics = arc.front()
    idx = [METRIC_KEYS.index(o) for o in p.objectives]
    cols = np.asarray(metrics[:, idx], np.float64)
    keep = pareto_front(cols)
    front_designs = [{k: v[i] for k, v in designs.items()} for i in keep]
    obs.inc("serve.stale_served")
    return Result(
        objectives=p.objectives, front_objs=cols[keep],
        front_metrics=metrics[keep], front_designs=front_designs,
        trace=None,
        provenance=Provenance(
            cache_key=cache_key, engine="nsga", from_cache=True,
            n_evals_run=0, n_evals_banked=int(query.budget),
            n_evals_realloc=0, transferred_from=(), n_transfer_seeds=0,
            plateaued=False, elapsed_s=time.perf_counter() - t0,
            stale=True, tech=session.tech_label))


class JobHandle:
    """A client's grip on one async job: poll, await, cancel, stream.

    * ``poll()``    — freshest answer now: the final ``Result`` once the
      job is done, else the stale front admission served (if any), else
      ``None``.  Never blocks.
    * ``result(timeout)`` — block for the FINAL result (a stale front
      never satisfies it); raises ``TimeoutError`` / ``CancelledError``
      / the job's own exception.
    * ``cancel()``  — PENDING jobs are cancelled in the store (never
      run); RUNNING jobs get a cooperative stop at the next segment
      boundary, keeping their resume checkpoint on disk.
    * ``events()``  — iterate the run's ``SegmentEvent`` stream as
      segments complete, ending when the job does.
    """

    def __init__(self, job_id: str, store: JobStore):
        self.job_id = job_id
        self._store = store
        self._events: "queue.Queue[SegmentEvent]" = queue.Queue()
        self._done = threading.Event()
        self._control = RunControl()
        self._result: Optional[Result] = None
        self._stale: Optional[Result] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False

    # ---- state ----------------------------------------------------------
    def record(self) -> Optional[JobRecord]:
        """The job's durable store record, fresh from disk."""
        return self._store.get(self.job_id)

    def state(self) -> str:
        rec = self.record()
        return rec.state if rec is not None else jobs.FAILED

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def stale(self) -> Optional[Result]:
        """The possibly-stale front admission served under overload, or
        ``None`` when the job was scheduled normally."""
        return self._stale

    def poll(self) -> Optional[Result]:
        if self._done.is_set() and self._result is not None:
            return self._result
        return self._stale

    def result(self, timeout: Optional[float] = None) -> Result:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    # ---- events ---------------------------------------------------------
    def events(self, timeout: Optional[float] = None
               ) -> Iterator[SegmentEvent]:
        """Yield ``SegmentEvent``s as the worker streams them; returns
        when the job finishes (or ``timeout`` seconds pass with neither
        an event nor completion)."""
        while True:
            try:
                yield self._events.get(timeout=0.05)
            except queue.Empty:
                if self._done.is_set() and self._events.empty():
                    return
                if timeout is not None:
                    timeout -= 0.05
                    if timeout <= 0:
                        return

    def _push(self, ev: SegmentEvent) -> None:
        self._events.put(ev)

    # ---- cancellation ---------------------------------------------------
    def cancel(self) -> bool:
        """Request cancellation.  Returns ``False`` when the job already
        reached a terminal state."""
        rec = self.record()
        if rec is None or rec.state in jobs.TERMINAL:
            return False
        self._cancelled = True
        if rec.state == jobs.PENDING:
            # flip it in the store under the claim lock; a worker that
            # claims concurrently wins the race and we fall through to
            # the cooperative stop
            with file_lock(self._store._lock):
                rec = self.record()
                if rec is not None and rec.state == jobs.PENDING:
                    self._store.update(rec, state=jobs.CANCELLED)
                    self._finish_cancelled()
                    return True
        self._control.stop()        # RUNNING: stop at the next segment
        return True

    # ---- worker-side finalization ---------------------------------------
    def _finish(self, result: Result) -> None:
        self._result = result
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def _finish_cancelled(self) -> None:
        self._error = CancelledError(f"job {self.job_id} cancelled")
        self._done.set()


class Executor:
    """Thread-pool job runner over a durable ``JobStore``.

    ``session`` is the configuration template: each worker thread lazily
    takes a ``session.clone()`` of its own.  ``store`` defaults to
    ``<cache_dir>/jobs`` — co-located with the archives so one directory
    is the whole recoverable state of a serving fleet.

    ``stale_ttl_s`` bounds the staleness of overload-served fronts: a
    cached front whose archive was last refined more than ``stale_ttl_s``
    seconds ago is not served as a degradation answer — the query queues
    for fresh refinement instead (``None`` = any cached front serves,
    however old; the historic behavior)."""

    def __init__(self, session, store=None, max_workers: int = 2,
                 max_pending: int = 8,
                 stale_ttl_s: Optional[float] = None):
        self._session = session
        cfg = session._service_config()
        root = store if store is not None \
            else Path(cfg["cache_dir"]) / "jobs"
        self.store = root if isinstance(root, JobStore) else JobStore(root)
        self.max_pending = int(max_pending)
        self.stale_ttl_s = None if stale_ttl_s is None \
            else float(stale_ttl_s)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(max_workers),
            thread_name_prefix="repro-torch-serve")
        self._tls = threading.local()
        self._handles: Dict[str, JobHandle] = {}
        self._inflight = 0
        self._lock = threading.Lock()

    # ---- worker sessions -------------------------------------------------
    def _thread_session(self):
        s = getattr(self._tls, "session", None)
        if s is None:
            s = self._tls.session = self._session.clone()
        return s

    # ---- submission ------------------------------------------------------
    def submit(self, query: Query, key=None,
               deadline_s: Optional[float] = None) -> JobHandle:
        """Durably record one query and either schedule it or — under
        overload, after waiting up to ``deadline_s`` for a slot — serve
        its freshest cached front immediately (``handle.stale``) and
        leave the refinement banked in the store.

        ``key`` is an integer PRNG seed (default 0): the job store must
        rebuild the exact key chain on a resume or in another process,
        so an opaque key array is not accepted."""
        if query.resolved_engine() != "nsga":
            raise ValueError(
                "submit_async serves the nsga engine (resumable scan "
                "segments); run scalarized engines via Session.submit")
        if key is None:
            seed = 0
        elif isinstance(key, (int, np.integer)):
            seed = int(key)
        else:
            raise ValueError(
                "submit_async takes an integer seed for key= (it must "
                "survive the durable job store); got "
                f"{type(key).__name__}")
        payload = query_to_payload(query)
        # the job's archive identity is derived under the QUERY's tech
        # (a per-query preset routes to a sibling session whose cache key
        # folds in that tech's digest)
        tsess = self._session._session_for(query.tech)
        ck = tsess._cache_key(query.problem)
        rec = self.store.create(payload, query.problem.key(), ck, seed)
        handle = JobHandle(rec.job_id, self.store)
        self._handles[rec.job_id] = handle
        obs.inc("serve.submitted")
        if not self._admit(deadline_s):
            stale = stale_result(tsess, query, ck,
                                 max_age_s=self.stale_ttl_s)
            if stale is not None:
                # overload + warm archive: answer now, bank the job
                handle._stale = stale
                obs.inc("serve.degraded")
                return handle
            obs.inc("serve.overflow")   # cold problem: nothing to serve
            #                             stale — queue it anyway
        self._schedule(handle)
        return handle

    def _admit(self, deadline_s: Optional[float]) -> bool:
        deadline = time.monotonic() + max(0.0, deadline_s or 0.0)
        while True:
            with self._lock:
                if self._inflight < self.max_pending:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def _schedule(self, handle: JobHandle) -> None:
        with self._lock:
            self._inflight += 1
        self._pool.submit(self._run_job, handle)

    # ---- recovery --------------------------------------------------------
    def resume_pending(self) -> List[JobHandle]:
        """Recover crashed RUNNING jobs (dead owner PID → PENDING) and
        schedule every PENDING job that has no live handle here —
        including refinements banked by an earlier overload degradation.
        Each resumed job restores its engine checkpoint and spends only
        the residual budget."""
        self.store.recover()
        out = []
        for rec in self.store.pending():
            h = self._handles.get(rec.job_id)
            if h is not None and not h.done() and h.stale is None:
                continue            # already scheduled here
            h = JobHandle(rec.job_id, self.store)
            self._handles[rec.job_id] = h
            self._schedule(h)
            out.append(h)
        return out

    # ---- the worker body -------------------------------------------------
    def _run_job(self, handle: JobHandle) -> None:
        try:
            rec = self.store.claim(handle.job_id)
            if rec is None:         # cancelled, or another worker won
                final = self.store.get(handle.job_id)
                if final is not None and final.state == jobs.CANCELLED:
                    handle._finish_cancelled()
                return
            run_job(self._thread_session(), self.store, rec,
                    handle=handle)
        except BaseException as e:  # never lose a pool thread silently
            handle._fail(e)
            warnings.warn(f"serve worker failed on {handle.job_id}: {e}")
        finally:
            with self._lock:
                self._inflight -= 1

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


def run_job(session, store: JobStore, rec: JobRecord,
            handle: Optional[JobHandle] = None,
            on_segment=None) -> Optional[Result]:
    """Run one CLAIMED job record to completion on ``session`` — the
    shared worker body of the in-process ``Executor`` and the
    ``repro_torch.serve.worker`` CLI.  Always ``resume=True``: if a previous
    attempt left an engine checkpoint, this attempt restores it and
    spends only the residual budget.  State transitions written back to
    the store: DONE (with the attempt's eval/elapsed ledger), CANCELLED
    (a cooperative stop requested by the handle), PENDING again (an
    interrupted-but-not-cancelled run, checkpoint kept), or FAILED."""
    control = handle._control if handle is not None else RunControl()
    if handle is not None:
        on_segment = handle._push
    try:
        q = query_from_payload(rec.payload)
        # a tech-named query resolves its preset HERE too — a worker that
        # cannot resolve it (missing $REPRO_CALIB_DIR / artifact) or
        # resolves different constants derives a different key and
        # refuses below, loudly, instead of refining the wrong archive
        ck = session._session_for(q.tech)._cache_key(q.problem)
        if ck != rec.cache_key:
            raise RuntimeError(
                f"job {rec.job_id}: session derives cache key {ck} but "
                f"the job was submitted under {rec.cache_key} — tech/"
                "constraint mismatch, refusing to refine the wrong "
                "archive")
        t0 = time.perf_counter()
        with obs.span("serve.job", job=rec.job_id, attempt=rec.attempts):
            res = session.submit(q, key=rec.seed, resume=True,
                                 control=control, on_segment=on_segment)
        elapsed = time.perf_counter() - t0
        rec.n_evals_attempts.append(int(res.provenance.n_evals_run))
        rec.elapsed_attempts.append(float(elapsed))
        if res.provenance.interrupted:
            cancelled = handle is not None and handle._cancelled
            store.update(rec,
                         state=jobs.CANCELLED if cancelled
                         else jobs.PENDING,
                         owner_pid=None)
            if handle is not None:
                if cancelled:
                    handle._finish_cancelled()
                else:
                    handle._fail(InterruptedError(
                        f"job {rec.job_id} interrupted; checkpoint kept"))
            obs.inc("serve.interrupted")
            return None
        store.update(rec, state=jobs.DONE, owner_pid=None)
        if handle is not None:
            handle._finish(res)
        obs.inc("serve.completed")
        return res
    except Exception as e:
        store.update(rec, state=jobs.FAILED, owner_pid=None,
                     error=f"{type(e).__name__}: {e}")
        if handle is not None:
            handle._fail(e)
        obs.inc("serve.failed")
        raise


__all__ = ["CancelledError", "Executor", "JobHandle",
           "query_from_payload", "query_to_payload", "run_job",
           "stale_result"]
