"""The port's async serving layer (``repro_torch.serve``) on the CPU.

* the 23 cases of ``tests/test_serve.py`` on the port, with
  ``Session(device="cpu")`` and ``--device cpu`` workers (the 7 the
  reference marks ``slow`` keep the mark): durable ``JobStore`` claims and
  crash recovery, query payload round-trips, ``submit_async`` handles
  (poll / await / cancel / streamed events), overload degradation to stale
  cached fronts, cooperative interrupt and checkpointed resume
  (bit-identical front, residual-only spend, a real SIGKILL of a worker
  process included), the manifest and archive lost-update regressions,
  plateau streaks across top-ups and run-partitioned journal replay;
* across the packages: ``query_to_payload`` of one query is the
  reference's dict (and both refuse the same queries), ``graph_to_json`` of
  every ``workload_library()`` graph is the reference's, a ``JobRecord``
  written by either package's ``JobStore`` loads field for field in the
  other's, and the ``Problem.key()`` a port job records is the
  reference's;
* the repairs that several threads of one process need: one kernel build
  and one library load when two threads reach a kernel's first use at
  once, exact launch counters, the device type in a checkpoint's
  signature, per-thread temporary files for job records; ``Session.clone``,
  ``repro_torch.api.submit``, and a worker without a card refusing to
  start unless ``--device cpu`` is given.
"""

import ast
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.api import Problem as RefProblem
from repro.api import Query as RefQuery
from repro.core import presets as ref_presets
from repro.explore.service import BudgetPolicy as RefBudgetPolicy
from repro.serve import JobStore as RefJobStore
from repro.serve import graph_from_json as ref_graph_from_json
from repro.serve import graph_to_json as ref_graph_to_json
from repro.serve import query_from_payload as ref_query_from_payload
from repro.serve import query_to_payload as ref_query_to_payload

import repro_torch.core as C
from repro_torch import api as port_api
from repro_torch import obs
from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as P
from repro_torch.core.workload import (WorkloadGraph, matmul,
                                       workload_features)
from repro_torch.explore import api as explore_api
from repro_torch.explore.archive import (MANIFEST_NAME, ArchiveManifest,
                                         ConvergenceTrace, ParetoArchive)
from repro_torch.explore.nsga import NSGAConfig
from repro_torch.explore.service import (BudgetPolicy, ExplorationService,
                                         PlateauState, RunControl)
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import launch as klaunch
from repro_torch.serve import (CANCELLED, DONE, PENDING, RUNNING,
                               CancelledError, Executor, JobHandle, JobStore,
                               graph_from_json, graph_to_json,
                               query_from_payload, query_to_payload, run_job)

TINY = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")
ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


def _graph(k=64):
    return WorkloadGraph([matmul("mm", 512, 512, k)], [])


def _problem(k=64):
    return Problem(_graph(k), objectives=OBJ, ch_max=2, space_kwargs=TINY)


def _ref_problem(k=64):
    return RefProblem(RC.WorkloadGraph([RC.matmul("mm", 512, 512, k)], []),
                      objectives=OBJ, ch_max=2, space_kwargs=TINY)


def _session(tmp_path, **policy_kw):
    policy_kw.setdefault("chunk_generations", 1)
    policy_kw.setdefault("adaptive", False)
    return Session(cache_dir=tmp_path,
                   nsga=NSGAConfig(pop=8, generations=2),
                   policy=BudgetPolicy(**policy_kw), device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# JobStore: durable records, lock-arbitrated claims, crash recovery
# ---------------------------------------------------------------------------
def test_jobstore_lifecycle_and_claim_exclusivity(tmp_path):
    store = JobStore(tmp_path / "jobs")
    rec = store.create({"budget": 64}, "pkey", "ckey", seed=7)
    assert rec.state == PENDING and rec.seed == 7 and rec.attempts == 0
    got = store.get(rec.job_id)
    assert got.payload == {"budget": 64} and got.problem_key == "pkey"
    assert [r.job_id for r in store.pending()] == [rec.job_id]

    claimed = store.claim(rec.job_id)
    assert claimed.state == RUNNING and claimed.owner_pid == os.getpid()
    assert claimed.attempts == 1
    # a second claim of a RUNNING job loses
    assert store.claim(rec.job_id) is None
    assert store.pending() == []

    store.update(claimed, state=DONE, owner_pid=None,
                 n_evals_attempts=[64])
    final = store.get(rec.job_id)
    assert final.state == DONE and final.n_evals_attempts == [64]
    assert store.claim(rec.job_id) is None      # terminal stays terminal


def test_jobstore_recover_flips_dead_owners_only(tmp_path):
    store = JobStore(tmp_path / "jobs")
    dead = store.create({}, "p1", "c1", 0)
    live = store.create({}, "p2", "c2", 0)
    # a PID that is certainly dead: a child that already exited
    child = subprocess.Popen(["true"])
    child.wait()
    store.update(store.claim(dead.job_id), owner_pid=child.pid)
    store.claim(live.job_id)                    # owned by US (alive)
    recovered = store.recover()
    assert [r.job_id for r in recovered] == [dead.job_id]
    assert store.get(dead.job_id).state == PENDING
    assert store.get(dead.job_id).owner_pid is None
    assert store.get(live.job_id).state == RUNNING


def test_jobstore_tolerates_torn_record(tmp_path):
    store = JobStore(tmp_path / "jobs")
    ok = store.create({}, "p", "c", 0)
    (store.root / "job-deadbeef0000.json").write_text('{"torn":')
    with pytest.warns(UserWarning, match="unreadable job record"):
        recs = store.jobs()
    assert [r.job_id for r in recs] == [ok.job_id]


# ---------------------------------------------------------------------------
# payload round-trip: the job store must rebuild the exact Problem
# ---------------------------------------------------------------------------
def test_query_payload_roundtrips_problem_key():
    q = Query(_problem(), budget=96, engine="nsga", transfer=True)
    pay = json.loads(json.dumps(query_to_payload(q)))   # through JSON
    q2 = query_from_payload(pay)
    assert q2.problem.key() == q.problem.key()
    assert q2.problem == q.problem
    assert (q2.budget, q2.engine, q2.transfer) == (96, "nsga", True)
    # the graph round-trip alone is exact too
    g2 = graph_from_json(json.loads(json.dumps(graph_to_json(_graph()))))
    assert Problem(g2, OBJ, 2, TINY).key() == _problem().key()


def test_query_payload_rejects_non_durable_options():
    with pytest.raises(ValueError, match="do not survive"):
        query_to_payload(Query(_problem(), engine="nsga",
                               policy=BudgetPolicy()))
    with pytest.raises(ValueError, match="do not survive"):
        query_to_payload(Query(_problem(), engine="nsga",
                               seed_designs=[{"x": 1}]))


def test_executor_submit_rejects_opaque_keys_and_engines(tmp_path):
    sess = _session(tmp_path)
    ex = Executor(sess, store=tmp_path / "jobs")
    with pytest.raises(ValueError, match="integer seed"):
        ex.submit(Query(_problem(), engine="nsga"),
                  key=np.zeros(2, np.uint32))     # a key array, not a seed
    with pytest.raises(ValueError, match="nsga engine"):
        ex.submit(Query(_problem(), engine="bo_sa", weights=(1.0, 1.0)))
    ex.shutdown()


# ---------------------------------------------------------------------------
# plateau streak semantics (incl. the reallocation-reset regression)
# ---------------------------------------------------------------------------
def test_plateau_state_observe_reset_and_count():
    st = PlateauState()
    hv = np.array([1.0, 2.0])
    assert st.observe(hv, 0.01) == 0        # first look: nothing to judge
    assert st.observe(hv, 0.01) == 1        # flat -> streak grows
    assert st.observe(hv, 0.01) == 2
    assert st.observe(hv * 1.5, 0.01) == 0  # improvement resets
    # count=False records the hv as the next comparison base WITHOUT
    # judging (the empty-archive segment case)
    st2 = PlateauState()
    st2.observe(hv, 0.01)
    st2.observe(hv, 0.01)
    assert st2.observe(hv, 0.01, count=False) == 1  # streak untouched
    assert st2.observe(hv, 0.01) == 2       # judged against recorded hv
    st2.reset()
    assert st2.streak == 0 and st2.last_hv is None


def test_realloc_topup_gets_fresh_plateau_window():
    """A run plateaus (streak == patience), then a reallocation top-up
    extends it with fresh budget: the reset gives the top-up its own
    window, so an improving top-up never reads as plateaued."""
    patience = 2
    st = PlateauState()
    flat = np.array([5.0])
    for _ in range(patience + 1):
        st.observe(flat, 0.01)
    assert st.streak >= patience            # plateaued: budget banked
    topup = ConvergenceTrace(
        objectives=OBJ, pairs=((OBJ[0], OBJ[1]),),
        front_size=np.array([4, 5, 6]),
        hypervolume=np.array([[5.0], [5.5], [6.1]]),
        best=np.zeros(3), feasible_frac=np.ones(3),
        n_evals=np.array([8, 16, 24]),
        archive_hv=np.array([[5.0], [5.5], [6.1]]))
    st.reset()                              # what _reallocate does
    for row in topup.archive_hv:
        streak = st.observe(row, 0.01)
        assert streak < patience, (
            "an improving top-up must never read as plateaued")


# ---------------------------------------------------------------------------
# journal: run-partitioned replay + live concurrent reads
# ---------------------------------------------------------------------------
def test_replay_partitions_overlapping_runs():
    recs = [  # two submissions of one problem, records interleaved
        dict(type="plan", key="k1", run="A", segments=[{}, {}], t=0.0),
        dict(type="segment", key="k1", run="A", n_evals=8, hv=[10.0],
             t=1.0),
        dict(type="segment", key="k1", run="B", n_evals=8, hv=[3.0],
             t=2.0),
        dict(type="segment", key="k1", run="A", n_evals=8, hv=[12.0],
             t=3.0),
        dict(type="result", key="k1", run="A", t=4.0),
        dict(type="segment", key="k1", run="B", n_evals=8, hv=[4.0],
             t=5.0),
        dict(type="result", key="k1", run="B", t=6.0),
    ]
    k = obs.replay(recs)["k1"]
    assert k["runs"]["A"]["hv_path"] == [10.0, 12.0]
    assert k["runs"]["B"]["hv_path"] == [3.0, 4.0]
    assert k["runs"]["A"]["segments"] == 2
    assert k["segments"] == 4 and k["n_evals"] == 32
    assert len(k["results"]) == 2 and k["planned_segments"] == 2
    assert k["final_hv"] == 4.0 and k["hv_path"] == [3.0, 4.0]


def test_replay_without_run_stamps_is_unchanged():
    recs = [
        dict(type="segment", key="k1", n_evals=8, hv=[1.0], t=1.0),
        dict(type="result", key="k1", t=2.0),
    ]
    k = obs.replay(recs)["k1"]
    assert k["segments"] == 1 and k["final_hv"] == 1.0
    assert list(k["runs"]) == [None]


def test_run_context_stamps_records_thread_locally():
    captured = []
    obs.add_sink(captured.append)
    try:
        with obs.run_context("r1"):
            assert obs.current_run() == "r1"
            obs.emit({"type": "x"})
            with obs.run_context("r2"):     # innermost wins
                obs.emit({"type": "y"})
            # a sibling thread without a context stays unstamped
            t = threading.Thread(target=lambda: obs.emit({"type": "z"}))
            t.start()
            t.join()
        obs.emit({"type": "w"})             # outside: unstamped
    finally:
        obs.remove_sink(captured.append)
    by_type = {r["type"]: r for r in captured}
    assert by_type["x"]["run"] == "r1"
    assert by_type["y"]["run"] == "r2"
    assert "run" not in by_type["z"] and "run" not in by_type["w"]


def test_journal_concurrent_writer_reader(tmp_path):
    """A reader polling a journal under active append sees only whole
    records and never warns about the writer's in-flight tail."""
    p = tmp_path / "live.jsonl"
    j = obs.Journal(p)
    N = 200

    def write():
        for i in range(N):
            j.write({"type": "seg", "i": i})
    t = threading.Thread(target=write)
    t.start()
    seen = 0
    deadline = time.monotonic() + 30
    while seen < N and time.monotonic() < deadline:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            recs = list(obs.read_journal(p)) if p.exists() else []
        assert all(r["type"] == "seg" for r in recs)
        assert [r["i"] for r in recs] == list(range(len(recs)))
        seen = len(recs)
    t.join()
    j.close()
    assert seen == N


# ---------------------------------------------------------------------------
# shared-cache writes: the lost-update regressions
# ---------------------------------------------------------------------------
def _group_for(svc, k=64):
    g = _graph(k)
    spec = C.SystemSpec.build(g, ch_max=2)
    space = C.DesignSpace(spec, **TINY)
    key = svc.problem_key(spec, space)
    arc = svc.archive_for(spec, space, key=key)
    return key, dict(arc=arc, spec=spec, space=space,
                     embedding=workload_features(spec.graph))


def _insert_row(arc, vals):
    designs = {k: v[:1] for k, v in arc.designs.items()}
    arc.insert(designs, np.asarray([vals], np.float64),
               count_evals=False)
    arc.n_evals += 8                        # an explicit 8-eval "run"


def _rows(arc):
    return {tuple(r) for r in arc.objs[arc.valid].tolist()}


def test_manifest_lost_update_is_fixed(tmp_path):
    """Service 1 snapshots the manifest, service 2 commits an entry, then
    service 1 commits ITS entry from the stale snapshot: the locked commit
    merges the snapshot into a fresh read of the disk state."""
    s1 = ExplorationService(cache_dir=tmp_path, device="cpu")
    s2 = ExplorationService(cache_dir=tmp_path, device="cpu")
    m1 = s1.manifest                        # stale snapshot of record
    ck2, g2 = _group_for(s2, k=96)
    s2._update_manifest(ck2, g2)            # peer commits first
    ck1, g1 = _group_for(s1, k=64)
    s1._update_manifest(ck1, g1, m=m1)      # commit from the snapshot
    disk = ArchiveManifest.load(tmp_path / MANIFEST_NAME)
    assert ck1 in disk.entries, "slower writer lost its own entry"
    assert ck2 in disk.entries, \
        "lost update: the slower writer dropped the faster one's entry"
    assert ck1 in s1.manifest.entries and ck2 in s1.manifest.entries


def test_archive_save_merges_peer_rows(tmp_path):
    """Two services refining ONE problem against one cache directory: the
    second save unions with what the first put on disk."""
    s1 = ExplorationService(cache_dir=tmp_path, device="cpu")
    s2 = ExplorationService(cache_dir=tmp_path, device="cpu")
    key, g1 = _group_for(s1)
    _insert_row(g1["arc"], [1.0, 2.0, 1.0, 1.0])
    s1.save(key)
    time.sleep(0.01)                        # distinct mtimes
    _key2, g2 = _group_for(s2)              # loads s1's row from disk
    assert _key2 == key and len(g2["arc"]) == 1
    _insert_row(g2["arc"], [2.0, 1.0, 1.0, 1.0])    # nondominated peer
    _insert_row(g1["arc"], [0.5, 3.0, 1.0, 1.0])
    s1.save(key)                            # disk: rows {1, 3}
    time.sleep(0.01)
    s2.save(key)                            # must merge, not clobber
    disk = ParetoArchive.load(s1._path(key), device="cpu")
    rows = _rows(disk)
    assert (1.0, 2.0, 1.0, 1.0) in rows
    assert (2.0, 1.0, 1.0, 1.0) in rows
    assert (0.5, 3.0, 1.0, 1.0) in rows, \
        "lost update: the slower save dropped the faster one's rows"
    assert disk.n_evals == 16               # max of both ledgers, not sum


_CHILD = r"""
import sys, time
from pathlib import Path
import numpy as np
import repro_torch.core as C
from repro_torch.core.workload import (WorkloadGraph, matmul,
                                       workload_features)
from repro_torch.explore.service import ExplorationService

cache, go, k_own, row0 = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    float(sys.argv[4])
TINY = dict(max_shape=(16, 16, 4, 4, 1, 2))

def group(svc, k):
    g = WorkloadGraph([matmul("mm", 512, 512, k)], [])
    spec = C.SystemSpec.build(g, ch_max=2)
    space = C.DesignSpace(spec, **TINY)
    key = svc.problem_key(spec, space)
    arc = svc.archive_for(spec, space, key=key)
    return key, dict(arc=arc, spec=spec, space=space,
                     embedding=workload_features(spec.graph))

svc = ExplorationService(cache_dir=cache, device="cpu")
shared_key, shared = group(svc, 64)         # both children share this
own_key, own = group(svc, k_own)            # unique per child
designs = {k: v[:1] for k, v in shared["arc"].designs.items()}
shared["arc"].insert(designs, np.asarray([[row0, 1.0 / row0, 1.0, 1.0]]))
shared["arc"].n_evals += 8
Path(go + f".ready.{k_own}").touch()        # signal armed, then block
while not Path(go).exists():                # on the start barrier so
    time.sleep(0.005)                       # both processes race
svc.save(shared_key)                        # race the peer on purpose
svc._update_manifest(shared_key, shared)
svc._update_manifest(own_key, own)
print("OK", shared_key, own_key)
"""


@pytest.mark.slow
def test_two_processes_race_shared_cache_writes(tmp_path):
    """Two real processes save the same archive and commit manifest
    entries near-simultaneously (a go-file barrier lines them up): every
    row and every index entry survives, whichever process writes last."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    cache, go = tmp_path / "cache", tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(cache), str(go), str(k), str(r)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k, r in ((96, 2.0), (128, 4.0))]
    deadline = time.monotonic() + 240
    while not all((tmp_path / f"go.ready.{k}").exists()
                  for k in (96, 128)):
        assert time.monotonic() < deadline, "children never got ready"
        assert all(p.poll() is None for p in procs), \
            [p.communicate() for p in procs]
        time.sleep(0.05)
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    keys = [out.split()[1:3] for out, _ in outs]
    shared_key = keys[0][0]
    assert keys[1][0] == shared_key
    rows = _rows(ParetoArchive.load(cache / f"{shared_key}.npz",
                                    device="cpu"))
    assert (2.0, 0.5, 1.0, 1.0) in rows and (4.0, 0.25, 1.0, 1.0) in rows
    m = ArchiveManifest.load(cache / MANIFEST_NAME)
    for ck in {shared_key, keys[0][1], keys[1][1]}:
        assert ck in m.entries, f"lost manifest entry {ck}"


# ---------------------------------------------------------------------------
# submit_async: handles, events, overload degradation, cancellation
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_submit_async_matches_sync_bit_for_bit(tmp_path):
    q = Query(_problem(), budget=64, engine="nsga")
    sync = _session(tmp_path / "sync").submit(q)            # seed 0
    sess = _session(tmp_path / "async")
    h = sess.submit_async(q)                                # seed 0
    evs = list(h.events(timeout=300))
    r = h.result(timeout=300)
    assert h.done() and h.state() == DONE
    assert r.front_objs.tobytes() == sync.front_objs.tobytes()
    assert r.front_metrics.tobytes() == sync.front_metrics.tobytes()
    assert r.provenance.n_evals_run == 64
    # 64 evals / (pop 8 * chunk 1) = 8 streamed segments
    assert len(evs) == 8
    assert [e.segment for e in evs] == list(range(8))
    rec = h.record()
    assert rec.state == DONE and rec.attempts == 1
    assert rec.n_evals_attempts == [64]
    assert rec.problem_key == q.problem.key()
    sess.executor().shutdown()


@pytest.mark.slow
def test_overload_serves_stale_front_and_banks_refinement(tmp_path):
    sess = _session(tmp_path)
    q = Query(_problem(), budget=64, engine="nsga")
    warmed = sess.submit(q)                 # warm the archive first
    ex = Executor(sess, store=tmp_path / "jobs", max_workers=1,
                  max_pending=0)            # always overloaded
    h = ex.submit(q, deadline_s=0.0)
    # answered immediately from the cache, zero evaluations spent
    stale = h.poll()
    assert stale is not None and stale is h.stale
    pv = stale.provenance
    assert pv.stale and pv.from_cache and pv.n_evals_run == 0
    assert pv.n_evals_banked == 64
    assert stale.front_objs.tobytes() == warmed.front_objs.tobytes()
    # the refinement is banked, not dropped: the job is PENDING on disk
    assert not h.done() and h.state() == PENDING
    # ... and a later capacity window picks it up
    handles = ex.resume_pending()
    assert [x.job_id for x in handles] == [h.job_id]
    r = handles[0].result(timeout=300)
    assert handles[0].state() == DONE
    assert r.provenance.from_cache          # budget was already covered
    ex.shutdown()


@pytest.mark.slow
def test_stale_ttl_bounds_overload_serving(tmp_path):
    """``Executor(stale_ttl_s=...)``: under overload, a cached front younger
    than the TTL serves as the degradation answer; an older one queues the
    query for fresh refinement instead."""
    sess = _session(tmp_path)
    q = Query(_problem(), budget=64, engine="nsga")
    sess.submit(q)                          # warm the archive
    npz = sess.service._path(sess._cache_key(q.problem))
    assert npz.exists()
    ex = Executor(sess, store=tmp_path / "jobs", max_workers=1,
                  max_pending=0, stale_ttl_s=3600.0)
    h = ex.submit(q, deadline_s=0.0)
    assert h.stale is not None and h.stale.provenance.stale
    ex.shutdown()
    old = time.time() - 7200.0
    os.utime(npz, (old, old))
    ex2 = Executor(sess, store=tmp_path / "jobs2", max_workers=1,
                   max_pending=0, stale_ttl_s=3600.0)
    h2 = ex2.submit(q, deadline_s=0.0)
    assert h2.stale is None
    r = h2.result(timeout=300)              # ran fresh instead
    assert h2.state() == DONE and not r.provenance.stale
    ex2.shutdown()


@pytest.mark.slow
def test_overload_cold_problem_queues_anyway(tmp_path):
    """A cold problem (empty archive) is queued past the admission bound
    rather than answered with nothing."""
    sess = _session(tmp_path)
    ex = Executor(sess, store=tmp_path / "jobs", max_workers=1,
                  max_pending=0)
    h = ex.submit(Query(_problem(), budget=64, engine="nsga"),
                  deadline_s=0.0)
    assert h.stale is None
    r = h.result(timeout=300)
    assert h.state() == DONE and r.provenance.n_evals_run == 64
    ex.shutdown()


def test_cancel_pending_job_never_runs(tmp_path):
    store = JobStore(tmp_path / "jobs")
    rec = store.create(query_to_payload(Query(_problem(), engine="nsga",
                                              budget=64)),
                       _problem().key(), "ck", 0)
    h = JobHandle(rec.job_id, store)
    assert h.cancel() is True
    assert h.state() == CANCELLED
    with pytest.raises(CancelledError):
        h.result(timeout=1)
    assert store.claim(rec.job_id) is None  # a worker can never win it
    assert h.cancel() is False              # already terminal


def test_cancelled_running_job_keeps_checkpoint_state(tmp_path):
    """run_job's cancel branch: the handle's stop token is set before the
    engine starts, so the run interrupts at the first segment boundary and
    the store lands on CANCELLED."""
    sess = _session(tmp_path)
    store = JobStore(tmp_path / "jobs")
    q = Query(_problem(), budget=64, engine="nsga")
    rec = store.create(query_to_payload(q), q.problem.key(),
                       sess._cache_key(q.problem), 0)
    h = JobHandle(rec.job_id, store)
    h._cancelled = True
    h._control.stop()
    claimed = store.claim(rec.job_id)
    run_job(sess, store, claimed, handle=h)
    assert store.get(rec.job_id).state == CANCELLED
    with pytest.raises(CancelledError):
        h.result(timeout=1)


# ---------------------------------------------------------------------------
# crash-resume: cooperative interrupt and a real SIGKILL
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_interrupt_then_resume_is_bit_identical(tmp_path):
    """Stop a run at a segment boundary, restart in a FRESH session: only
    the residual budget is spent and the final front is bit-identical to
    an uninterrupted run."""
    q = Query(_problem(), budget=64, engine="nsga")
    key = 3
    r0 = _session(tmp_path / "base").submit(q, key=key)

    sA = _session(tmp_path / "crash")
    ctl = RunControl()
    seen = []

    def stop_after_two(ev):
        seen.append(ev)
        if len(seen) == 2:
            ctl.stop()
    r1 = sA.submit(q, key=key, resume=True, control=ctl,
                   on_segment=stop_after_two)
    assert r1.provenance.interrupted and r1.provenance.n_evals_run == 16
    ck = sA._cache_key(q.problem)
    assert (tmp_path / "crash" / f"{ck}.ckpt.npz").exists()

    sB = _session(tmp_path / "crash")       # a new process, effectively
    r2 = sB.submit(q, key=key, resume=True)
    assert not r2.provenance.interrupted
    assert r1.provenance.n_evals_run + r2.provenance.n_evals_run \
        == r0.provenance.n_evals_run == 64
    assert r2.front_objs.tobytes() == r0.front_objs.tobytes()
    assert r2.front_metrics.tobytes() == r0.front_metrics.tobytes()
    assert not (tmp_path / "crash" / f"{ck}.ckpt.npz").exists()


@pytest.mark.slow
def test_sigkill_worker_then_restart_resumes(tmp_path):
    """A real ``--device cpu`` worker process is SIGKILLed mid-segment; a
    restarted worker recovers the job, restores the checkpoint, spends only
    the residual budget and lands on the uninterrupted run's front."""
    q = Query(_problem(), budget=64, engine="nsga")
    seed = 5
    _session(tmp_path / "base").submit(q, key=seed)     # uninterrupted

    cache, store_dir = tmp_path / "cache", tmp_path / "store"
    sess = _session(cache)                  # same config as the workers
    ck = sess._cache_key(q.problem)
    store = JobStore(store_dir)
    rec = store.create(query_to_payload(q), q.problem.key(), ck, seed)

    worker_cmd = [sys.executable, "-m", "repro_torch.serve.worker",
                  "--store", str(store_dir), "--cache", str(cache),
                  "--once", "--pop", "8", "--chunk-generations", "1",
                  "--no-adaptive", "--device", "cpu"]
    w1 = subprocess.Popen(worker_cmd + ["--segment-delay", "1.0"],
                          env=_env(), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    try:
        ckpt = cache / f"{ck}.ckpt.npz"
        deadline = time.monotonic() + 240
        while not ckpt.exists():            # >= 1 segment checkpointed
            assert w1.poll() is None, w1.communicate()
            assert time.monotonic() < deadline, "no checkpoint appeared"
            time.sleep(0.05)
        time.sleep(0.3)                     # well inside the delay window
        w1.send_signal(signal.SIGKILL)
        w1.wait(timeout=30)
    finally:
        if w1.poll() is None:
            w1.kill()
        w1.communicate()
    after_kill = store.get(rec.job_id)
    assert after_kill.state == RUNNING      # the crash left it claimed
    assert ckpt.exists()

    w2 = subprocess.run(worker_cmd, env=_env(), capture_output=True,
                        text=True, timeout=400)
    assert w2.returncode == 0, w2.stderr
    lines = [json.loads(ln) for ln in w2.stdout.splitlines() if ln]
    states = {ln.get("state") for ln in lines}
    assert "RECOVERED" in states            # dead owner detected
    done = [ln for ln in lines if ln.get("state") == DONE]
    assert len(done) == 1 and done[0]["attempts"] == 2
    assert 0 < done[0]["n_evals_attempts"][-1] < 64
    base = ParetoArchive.load(tmp_path / "base" / f"{ck}.npz", device="cpu")
    resumed = ParetoArchive.load(cache / f"{ck}.npz", device="cpu")
    assert resumed.objs[resumed.valid].numpy().tobytes() \
        == base.objs[base.valid].numpy().tobytes()
    assert int(resumed.n_evals) == 64       # nothing double-counted
    assert not ckpt.exists()                # consumed on completion


# ---------------------------------------------------------------------------
# across the packages: one payload, one graph JSON, one record format
# ---------------------------------------------------------------------------
PAYLOAD_CASES = {
    "matmul nsga transfer": lambda pkg: pkg["Query"](
        pkg["problem"](), budget=96, engine="nsga", transfer=True),
    "tech by name, weights": lambda pkg: pkg["Query"](
        pkg["problem"](96), budget=32, weights=(1.0, 2.0),
        tech="smoke_preset"),
    "library graph, bounded space": lambda pkg: pkg["Query"](
        pkg["Problem"](pkg["library"]()["attn_qwen2_72b"], OBJ, ch_max=3,
                       space_kwargs=dict(max_total_pes=4096)), budget=512),
}
REFUSED_CASES = {
    "policy": lambda pkg: pkg["Query"](pkg["problem"](), engine="nsga",
                                       policy=pkg["BudgetPolicy"]()),
    "seed_designs": lambda pkg: pkg["Query"](pkg["problem"](),
                                             seed_designs=[{"x": 1}]),
    "engine_opts": lambda pkg: pkg["Query"](
        pkg["problem"](), engine="bo_sa", weights=(1.0, 1.0),
        engine_opts=dict(n_init=2)),
    "raw tech": lambda pkg: pkg["Query"](pkg["problem"](),
                                         tech=pkg["tech"]),
}
PORT = dict(Query=Query, Problem=Problem, problem=_problem,
            library=P.workload_library, BudgetPolicy=BudgetPolicy,
            tech=C.DEFAULT_TECH, to_payload=query_to_payload)
REF = dict(Query=RefQuery, Problem=RefProblem, problem=_ref_problem,
           library=ref_presets.workload_library,
           BudgetPolicy=RefBudgetPolicy, tech=RC.DEFAULT_TECH,
           to_payload=ref_query_to_payload)


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_query_payload_equals_the_reference(case):
    mine = json.loads(json.dumps(query_to_payload(PAYLOAD_CASES[case](PORT))))
    ref = json.loads(json.dumps(ref_query_to_payload(
        PAYLOAD_CASES[case](REF))))
    assert mine == ref
    # each package rebuilds the other's payload to the same problem
    assert query_from_payload(ref).problem.key() \
        == ref_query_from_payload(mine).problem.key()


@pytest.mark.parametrize("case", sorted(REFUSED_CASES))
def test_query_payload_refusals_equal_the_reference(case):
    with pytest.raises(ValueError) as ref_err:
        ref_query_to_payload(REFUSED_CASES[case](REF))
    with pytest.raises(ValueError) as port_err:
        query_to_payload(REFUSED_CASES[case](PORT))
    # the same refusal, up to the package's name
    assert str(port_err.value).replace("repro_torch", "repro") \
        == str(ref_err.value)


@pytest.mark.parametrize("name", sorted(P.workload_library()))
def test_graph_to_json_equals_the_reference(name):
    mine = graph_to_json(P.workload_library()[name])
    ref = ref_graph_to_json(ref_presets.workload_library()[name])
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(ref))
    # and each package reads the other's JSON back to the same problem
    back = ref_graph_from_json(json.loads(json.dumps(mine)))
    assert RefProblem(back, OBJ, 2).key() \
        == Problem(graph_from_json(ref), OBJ, 2).key()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_job_record_loads_across_packages(tmp_path, writer):
    stores = dict(port=JobStore, reference=RefJobStore)
    w = stores[writer](tmp_path / "jobs")
    r = stores["reference" if writer == "port" else "port"](tmp_path / "jobs")
    payload = query_to_payload(Query(_problem(), budget=64))
    rec = w.create(payload, _problem().key(), "ck", seed=11)
    claimed = w.claim(rec.job_id)
    w.update(claimed, n_evals_attempts=[16], elapsed_attempts=[0.5],
             error="Boom: x")
    written = w.get(rec.job_id).to_json()
    got = r.get(rec.job_id)
    assert got is not None and got.to_json() == written
    assert [x.job_id for x in r.jobs()] == [rec.job_id]
    # the reader claims nothing it should not, and recovers nothing alive
    assert r.claim(rec.job_id) is None and r.recover() == ()


def test_recorded_problem_key_is_the_references(tmp_path):
    sess = _session(tmp_path)
    ex = Executor(sess, store=tmp_path / "jobs", max_workers=1)
    h = ex.submit(Query(_problem(), budget=16), key=2)
    h.result(timeout=300)
    ex.shutdown()
    rec = h.record()
    assert rec.problem_key == _ref_problem().key()
    assert rec.state == DONE and rec.seed == 2
    # the archive key is the port's own (salted), never the reference's
    assert rec.cache_key == sess._cache_key(_problem())


# ---------------------------------------------------------------------------
# several threads in one process: builds, loads, counters, records
# ---------------------------------------------------------------------------
def test_two_threads_build_one_library(tmp_path, monkeypatch):
    """Two threads that reach a kernel's first use at once: one build (one
    compile of the source and one link), one library, no temporary file
    left behind."""
    stub = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    stub.write_text(
        "#!/bin/sh\n"
        'case " $* " in *" -c "*) step=compile;; *) step=link;; esac\n'
        f"echo $step >> {calls}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi\n'
        "  shift\n"
        "done\n")
    stub.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(kbuild, "nvcc_path", lambda: str(stub))
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    go = threading.Barrier(2)
    out = []

    def build():
        go.wait()
        out.append(kbuild.build_library("stubk", [src]))
    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 2 and out[0] == out[1] and out[0].read_text() == "lib\n"
    assert calls.read_text().split() == ["compile", "link"]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) \
        == sorted([out[0].name, out[0].with_suffix(".log").name])


def test_library_loader_loads_once_under_threads():
    loaded = []

    def load():
        time.sleep(0.2)
        loaded.append(object())
        return loaded[-1]
    lib = kbuild.LibraryLoader("loader_test", load)
    go = threading.Barrier(4)
    got = []

    def call():
        go.wait()
        got.append(lib())
    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(loaded) == 1 and lib.loads == 1
    assert all(g is loaded[0] for g in got) and lib() is loaded[0]


def test_launch_counters_are_exact_under_threads():
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.launches_tc = 0
    n_threads, n_calls = 8, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)             # switch threads as often as
    try:                                    # the interpreter allows
        threads = [threading.Thread(target=lambda: [
            klaunch.count(wrapper, "launches", "launches_tc")
            for _ in range(n_calls)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == wrapper.launches_tc == n_threads * n_calls


@pytest.mark.parametrize("kernel", ["pareto_rank", "gp_cov",
                                    "flash_attention", "mamba_scan"])
def test_wrappers_count_through_the_lock(kernel):
    """Every wrapper adds to its counters through ``launch.count`` and
    loads its library through a ``LibraryLoader``: no bare ``+=`` on a
    counter and no unlocked cache."""
    path = ROOT / "src" / "repro_torch" / "kernels" / kernel / "ops.py"
    tree = ast.parse(path.read_text())
    bare = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)
            and isinstance(n.target, ast.Attribute)
            and n.target.attr.startswith("launches")]
    assert not bare
    counted = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "count"]
    assert counted
    ops = __import__(f"repro_torch.kernels.{kernel}.ops",
                     fromlist=["_lib"])
    assert isinstance(ops._lib, kbuild.LibraryLoader)


def test_checkpoint_of_another_device_type_is_ignored(tmp_path):
    """A card run's checkpoint is never finished on the CPU's stream: a
    checkpoint signed under another device type is ignored — the run
    spends its whole budget and lands where the same directory without
    the checkpoint lands."""
    q = Query(_problem(), budget=64, engine="nsga")
    sA = _session(tmp_path / "crash")
    ctl = RunControl()
    r1 = sA.submit(q, key=4, resume=True, control=ctl,
                   on_segment=lambda ev: ctl.stop())
    assert r1.provenance.interrupted and r1.provenance.n_evals_run == 8
    ck = sA._cache_key(q.problem)
    ckpt = f"{ck}.ckpt.npz"
    assert (tmp_path / "crash" / ckpt).exists()
    shutil.copytree(tmp_path / "crash", tmp_path / "same")
    shutil.copytree(tmp_path / "crash", tmp_path / "control")
    (tmp_path / "control" / ckpt).unlink()
    control = _session(tmp_path / "control").submit(q, key=4, resume=True)
    # under the device type it was signed with, the checkpoint resumes
    same = _session(tmp_path / "same").submit(q, key=4, resume=True)
    assert same.provenance.n_evals_run == 64 - 8

    sB = _session(tmp_path / "crash")
    real = type(sB.service)._ckpt_signature
    sigs = []

    def signed_on_the_card(self, *a, **kw):
        dev = self.device
        self.device = torch.device("cuda")   # the type only: no card used
        try:
            sigs.append(real(self, *a, **kw))
            return sigs[-1]
        finally:
            self.device = dev
    sB.service._ckpt_signature = types.MethodType(signed_on_the_card,
                                                  sB.service)
    r2 = sB.submit(q, key=4, resume=True)
    assert sigs                             # the resume read a signature
    assert not r2.provenance.interrupted
    assert r2.provenance.n_evals_run == control.provenance.n_evals_run
    assert r2.front_objs.tobytes() == control.front_objs.tobytes()
    assert r2.front_metrics.tobytes() == control.front_metrics.tobytes()
    # the device type alone changes the signature
    args = (OBJ, 64, 8, 8, 1, 4, None)
    assert real(sB.service, *args) != signed_on_the_card(sB.service, *args)


def test_job_record_writes_from_two_threads(tmp_path):
    """A client thread and a worker thread updating one job at once: each
    write goes through its own temporary file, none fails, the record stays
    readable and no temporary file is left."""
    store = JobStore(tmp_path / "jobs")
    rec = store.create({"budget": 64}, "p", "c", 0)
    errors = []
    go = threading.Barrier(2)

    def writer(tag):
        go.wait()
        try:
            for i in range(300):
                store.update(store.get(rec.job_id), error=f"{tag}{i}")
        except Exception as e:              # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=writer, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]
    assert store.get(rec.job_id).error in ("a299", "b299")
    assert [p.name for p in store.root.iterdir()
            if ".tmp" in p.name] == []


# ---------------------------------------------------------------------------
# the front door and the worker's device rule
# ---------------------------------------------------------------------------
def test_clone_shares_configuration_not_service(tmp_path):
    sess = Session(cache_dir=tmp_path, journal=tmp_path / "j.jsonl",
                   nsga=NSGAConfig(pop=8, generations=2), device="cpu")
    twin = sess.clone()
    assert twin.service is not sess.service
    assert twin._service_config() == sess._service_config()
    assert twin._journal is sess._journal
    assert twin.tech_label == sess.tech_label
    assert twin.service.device == torch.device("cpu")
    assert sess.executor() is sess.executor()
    with pytest.raises(RuntimeError, match="already initialized"):
        sess.executor(max_workers=3)
    sess.executor().shutdown()
    assert port_api.submit is explore_api.submit
    assert "submit" in port_api.__all__


def test_worker_without_a_card_refuses_to_start(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    store = JobStore(tmp_path / "store")
    store.create(query_to_payload(Query(_problem(), budget=16)),
                 _problem().key(), "ck", 0)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.worker", "--store",
         str(tmp_path / "store"), "--cache", str(tmp_path / "cache"),
         "--once"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "device='cpu'" in out.stderr
    assert out.stdout == ""
    assert [r.state for r in store.jobs()] == [PENDING]   # nothing claimed
