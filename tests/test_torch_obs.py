"""The port's flight recorder (``repro_torch.obs``) on the CPU.

* the 24 cases of ``tests/test_obs.py`` on the port's own copy and its
  ``Session(device="cpu")``: the metrics registry, span nesting and the
  zero-cost disabled path, crash-safe journal writes and truncated-tail
  reads, the event-stream invariants of instrumented submissions, fronts
  bit-identical with observability on or off, journal replay against the
  in-memory ``Result`` and the plan-vs-actual report;
* journals read across the packages: for one query submitted to both, the
  port writes the reference's record types with the reference's keys
  (times and ids aside), the port's journal replays through
  ``repro.obs.replay`` to the port's in-memory ``Result`` (segment count,
  evaluation total, final hypervolume), and the reference's journal
  replays and renders through the port's;
* ``Plan.predicted_s`` is ``None`` before any segment has run in-process
  and the reference's estimate after one has; tensors serialize.
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

import repro.core as RC
from repro import obs as ref_obs
from repro.api import Problem as RefProblem
from repro.api import Query as RefQuery
from repro.api import Session as RefSession
from repro.explore.nsga import NSGAConfig as RefNSGAConfig
from repro.explore.service import BudgetPolicy as RefBudgetPolicy
from repro.obs.report import render as ref_render

from repro_torch import obs
from repro_torch.api import Problem, Query, Session
from repro_torch.core.encoding import DesignSpace
from repro_torch.core.evaluate import SystemSpec
from repro_torch.core.optimizer import SAConfig
from repro_torch.core.workload import WorkloadGraph, matmul
from repro_torch.explore.nsga import NSGAConfig
from repro_torch.explore.service import BudgetPolicy, SegmentEvent
from repro_torch.obs.report import render

TINY = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")


@pytest.fixture(autouse=True)
def _obs_restored():
    """Module-level obs state (enable flag, sinks) never leaks between
    tests — the registry is process-wide by design, so tests assert on
    deltas, not absolutes."""
    yield
    obs.enable()
    for s in list(obs.trace._SINKS):
        obs.remove_sink(s)


def _graph(k=64):
    return WorkloadGraph([matmul("mm", 512, 512, k)], [])


def _session(tmp_path, journal=False, **policy_kw):
    policy = BudgetPolicy(**policy_kw) if policy_kw else BudgetPolicy()
    return Session(cache_dir=tmp_path / "cache", journal=journal,
                   nsga=NSGAConfig(pop=8, generations=2), policy=policy,
                   device="cpu")


def _problem(k=64):
    return Problem(_graph(k), objectives=OBJ, ch_max=2, space_kwargs=TINY)


def _counter(name):
    return obs.REGISTRY.counter(name).value


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_counter_gauge_histogram_basics():
    r = obs.MetricsRegistry()
    r.counter("c").inc().inc(4)
    assert r.counter("c").value == 5
    r.gauge("g").set(2.5)
    assert r.gauge("g").value == 2.5
    h = r.histogram("h")
    for v in range(100):
        h.observe(float(v))
    assert h.quantile(0.5) == 50.0
    assert h.quantiles() == {"p50": 50.0, "p90": 90.0, "p99": 99.0}
    assert h.mean == pytest.approx(49.5)
    assert (h.vmin, h.vmax, h.count) == (0.0, 99.0, 100)
    snap = r.snapshot()
    assert snap["c"] == {"kind": "counter", "value": 5}
    assert snap["h"]["p99"] == 99.0 and snap["h"]["count"] == 100
    json.dumps(snap)
    r.reset()
    assert r.snapshot() == {}


def test_histogram_reservoir_stays_bounded():
    r = obs.MetricsRegistry()
    h = r.histogram("h", capacity=32)
    for v in range(1000):
        h.observe(float(v))
    assert len(h._res) == 32 and h.count == 1000
    assert 0.0 <= h.quantile(0.5) <= 999.0
    # the same reservoir as the reference's (one seeded sampler per name)
    rh = ref_obs.MetricsRegistry().histogram("h", capacity=32)
    for v in range(1000):
        rh.observe(float(v))
    assert h._res == rh._res


def test_metric_name_bound_to_kind():
    r = obs.MetricsRegistry()
    r.counter("x")
    with pytest.raises(TypeError, match="is a Counter"):
        r.histogram("x")


def test_registry_thread_safety():
    r = obs.MetricsRegistry()

    def work():
        for _ in range(500):
            r.counter("n").inc()
            r.histogram("h").observe(1.0)

    ts = [threading.Thread(target=work) for _ in range(4)]
    [t.start() for t in ts]
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert r.counter("n").value == 2000
    assert r.histogram("h").count == 2000


# ---------------------------------------------------------------------------
# tracing core
# ---------------------------------------------------------------------------
def test_spans_nest_and_emit_records():
    recs = []
    with obs.sink_attached(recs.append):
        with obs.span("outer", k=1):
            with obs.span("inner"):
                pass
    inner, outer = recs
    assert inner["name"] == "inner" and inner["parent"] == "outer" \
        and inner["depth"] == 1
    assert outer["name"] == "outer" and outer["parent"] is None \
        and outer["attrs"] == {"k": 1}
    assert 0.0 <= inner["elapsed_s"] <= outer["elapsed_s"]
    assert obs.REGISTRY.histogram("span.inner").count >= 1


def test_disabled_is_a_shared_noop():
    obs.disable()
    try:
        assert obs.span("x") is obs.span("y") is obs.NOOP_SPAN
        assert not obs.active()
        before = obs.REGISTRY.counter("test.off").value
        obs.inc("test.off")
        assert obs.REGISTRY.counter("test.off").value == before
        recs = []
        with obs.sink_attached(recs.append):
            obs.emit({"type": "x"})
        assert recs == []
    finally:
        obs.enable()


def test_failing_sink_is_dropped_not_fatal():
    def bad(rec):
        raise OSError("disk full")
    before = _counter("obs.sink_errors")
    with obs.sink_attached(bad):
        obs.emit({"type": "x"})
        obs.emit({"type": "y"})
    assert _counter("obs.sink_errors") == before + 1


def test_sink_attached_is_reentrant():
    recs = []
    with obs.sink_attached(recs.append):
        with obs.sink_attached(recs.append):
            obs.emit({"type": "x"})
        obs.emit({"type": "y"})
    assert [r["type"] for r in recs] == ["x", "y"]
    with obs.sink_attached(None):
        obs.emit({"type": "z"})
    assert len(recs) == 2


def test_sink_attached_refcounts_across_overlapping_scopes():
    recs = []
    a = obs.sink_attached(recs.append)
    b = obs.sink_attached(recs.append)
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)
    obs.emit({"type": "late"})
    b.__exit__(None, None, None)
    obs.emit({"type": "gone"})
    assert [r["type"] for r in recs] == ["late"]


# ---------------------------------------------------------------------------
# journal: atomic lines, crash tolerance, replay
# ---------------------------------------------------------------------------
def test_journal_roundtrip_and_numpy_serialization(tmp_path):
    p = tmp_path / "j.jsonl"
    with obs.Journal(p) as j:
        j.write(dict(type="a", v=np.float32(1.5), arr=np.arange(3),
                     tup=(1, 2)))
        j.write(dict(type="b", n=np.int64(7)))
        # the port's one addition: tensors (0-d -> a number, else a list)
        j.write(dict(type="c", s=torch.tensor(2.5),
                     m=torch.arange(4, dtype=torch.int32).reshape(2, 2),
                     g=torch.ones(2, requires_grad=True)))
    recs = list(obs.read_journal(p))
    assert [r["type"] for r in recs] == ["a", "b", "c"]
    assert recs[0]["arr"] == [0, 1, 2] and recs[0]["tup"] == [1, 2]
    assert recs[1]["n"] == 7
    assert recs[2]["s"] == 2.5 and recs[2]["m"] == [[0, 1], [2, 3]]
    assert recs[2]["g"] == [1.0, 1.0]
    assert all("t" in r for r in recs)
    # the reference reads the port's file
    assert [r["type"] for r in ref_obs.read_journal(p)] == ["a", "b", "c"]


def test_journal_opens_lazily(tmp_path):
    j = obs.Journal(tmp_path / "lazy.jsonl")
    assert not j.path.exists()
    j.write({"type": "x"})
    assert j.path.exists()
    j.close()


def test_read_journal_tolerates_truncated_tail(tmp_path):
    p = tmp_path / "j.jsonl"
    with obs.Journal(p) as j:
        j.write({"type": "a"})
        j.write({"type": "b"})
    with open(p, "a") as f:
        f.write('{"type":"c","half')
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        recs = list(obs.read_journal(p))
    assert [r["type"] for r in recs] == ["a", "b"]
    p2 = tmp_path / "j2.jsonl"
    with obs.Journal(p2) as j:
        j.write({"type": "a"})
    with open(p2, "a") as f:
        f.write('{"type":"c"}')
    assert [r["type"] for r in obs.read_journal(p2)] == ["a", "c"]


def test_read_journal_warns_on_midfile_garbage(tmp_path):
    p = tmp_path / "j.jsonl"
    p.write_text('{"type":"a"}\nnot json at all\n{"type":"b"}\n')
    with pytest.warns(UserWarning, match="unparseable"):
        recs = list(obs.read_journal(p))
    assert [r["type"] for r in recs] == ["a", "b"]


def test_read_journal_directory(tmp_path):
    for name in ("b.jsonl", "a.jsonl"):
        with obs.Journal(tmp_path / name) as j:
            j.write({"type": name})
    assert [r["type"] for r in obs.read_journal(tmp_path)] \
        == ["a.jsonl", "b.jsonl"]


def test_replay_folds_segments_and_results():
    recs = [
        dict(type="plan", key="k1", segments=[{}, {}]),
        dict(type="segment", key="k1", phase="refine", n_evals=64,
             elapsed_s=0.5, hv=[10.0]),
        dict(type="segment", key="k1", phase="realloc", n_evals=32,
             elapsed_s=0.25, hv=[12.0]),
        dict(type="result", key="k1", n_evals=96),
        dict(type="span", name="x"),
    ]
    r = obs.replay(recs)["k1"]
    assert r["segments"] == 2 and r["planned_segments"] == 2
    assert r["segments_by_phase"] == {"refine": 1, "realloc": 1}
    assert r["n_evals"] == 96 and r["final_hv"] == 12.0
    assert r["hv_path"] == [10.0, 12.0] and len(r["results"]) == 1
    assert r == ref_obs.replay(recs)["k1"]       # the reference's fold


# ---------------------------------------------------------------------------
# instrumented runs: event-stream invariants
# ---------------------------------------------------------------------------
def test_segment_events_carry_timing_and_monotone_seq(tmp_path):
    s = _session(tmp_path, chunk_generations=2, adaptive=False)
    events = []
    r = s.submit(Query(_problem(), budget=32), on_segment=events.append)
    assert [e.segment for e in events] == [0, 1]
    assert [e.seq for e in events] == [0, 1]
    assert all(e.elapsed_s > 0.0 for e in events)
    whole = events[0].trace.extend(events[1].trace)
    np.testing.assert_array_equal(whole.n_evals, r.trace.n_evals)
    np.testing.assert_allclose(whole.archive_hv, r.trace.archive_hv)


def test_realloc_events_restart_segment_but_not_seq(tmp_path):
    s = _session(tmp_path)
    bank = BudgetPolicy(chunk_generations=1, plateau_rel=10.0, patience=1,
                        reallocate=False)
    r1 = s.submit(Query(_problem(64), budget=128, policy=bank))
    assert r1.provenance.plateaued and r1.provenance.n_evals_banked > 0
    spend = BudgetPolicy(chunk_generations=1, plateau_rel=0.0)
    events = []
    r2 = s.submit(Query(_problem(96), budget=16, policy=spend),
                  on_segment=events.append)
    assert r2.provenance.n_evals_realloc > 0
    phases = [e.phase for e in events]
    assert "refine" in phases and "realloc" in phases
    for phase in ("refine", "realloc"):
        idx = [e.segment for e in events if e.phase == phase]
        assert idx == list(range(len(idx)))
    assert [e.seq for e in events] == list(range(len(events)))
    assert all(e.cache_key == r2.provenance.cache_key for e in events)


def test_callback_failure_names_phase_and_segment(tmp_path):
    s = _session(tmp_path, chunk_generations=2, adaptive=False)
    jp = tmp_path / "j.jsonl"
    s._journal = obs.resolve_journal(jp)

    def boom(e):
        raise RuntimeError("dashboard down")

    before = _counter("obs.on_segment_errors")
    with pytest.warns(UserWarning,
                      match=r"on_segment callback failed .*"
                            r"\(phase=refine, segment=0\)"):
        s.submit(Query(_problem(), budget=32), on_segment=boom)
    assert _counter("obs.on_segment_errors") == before + 2
    errs = [r for r in obs.read_journal(jp)
            if r["type"] == "callback_error"]
    assert len(errs) == 2 and errs[0]["phase"] == "refine"
    assert [e["segment"] for e in errs] == [0, 1]


def test_scalarized_completion_event_and_journal(tmp_path):
    jp = tmp_path / "j.jsonl"
    s = _session(tmp_path, journal=jp)
    spec = SystemSpec.build(_graph(), ch_max=2)
    space = DesignSpace(spec, **TINY)
    events = []
    s.submit(Query(Problem.from_spec(spec, space), engine="bo_sa",
                   weights=(1.0, 1.0, 0.0, 0.0),
                   engine_opts=dict(bo_fields=(), n_init=2,
                                    sa=SAConfig(steps=10, chains=2))),
             on_segment=events.append)
    assert len(events) == 1 and isinstance(events[0], SegmentEvent)
    assert events[0].phase == "bo_sa" and events[0].elapsed_s > 0.0
    recs = list(obs.read_journal(jp))
    segs = [r for r in recs if r["type"] == "segment"]
    assert len(segs) == 1 and segs[0]["phase"] == "bo_sa"
    plans = [r for r in recs if r["type"] == "plan"]
    assert plans and plans[0]["engine"] == "bo_sa"
    assert any(r["type"] == "result" and r["engine"] == "bo_sa"
               for r in recs)


# ---------------------------------------------------------------------------
# observability is free: identical results on or off
# ---------------------------------------------------------------------------
def test_fronts_bit_identical_with_obs_on_and_off(tmp_path):
    q = Query(_problem(), budget=32)
    events = []
    jp = tmp_path / "j.jsonl"
    s_on = _session(tmp_path / "on", journal=jp, chunk_generations=2,
                    adaptive=False)
    r_on = s_on.submit(q, on_segment=events.append)
    obs.disable()
    try:
        s_off = _session(tmp_path / "off", chunk_generations=2,
                         adaptive=False)
        r_off = s_off.submit(q)
    finally:
        obs.enable()
    assert r_on.front_metrics.tobytes() == r_off.front_metrics.tobytes()
    assert r_on.front_objs.tobytes() == r_off.front_objs.tobytes()
    np.testing.assert_array_equal(r_on.trace.archive_hv,
                                  r_off.trace.archive_hv)
    assert len(events) == 2 and jp.exists()


# ---------------------------------------------------------------------------
# journal replay + report against the in-memory result
# ---------------------------------------------------------------------------
def test_journal_replays_to_in_memory_result(tmp_path):
    jp = tmp_path / "j.jsonl"
    s = _session(tmp_path, journal=jp, chunk_generations=2, adaptive=False)
    r = s.submit(Query(_problem(), budget=32))
    ck = r.provenance.cache_key
    recs = list(obs.read_journal(jp))
    rp = obs.replay(recs)[ck]
    assert rp["segments"] == r.trace.archive_hv.shape[0]
    assert rp["n_evals"] == r.provenance.n_evals_run
    assert rp["final_hv"] == pytest.approx(
        float(r.trace.archive_hv[-1, 0]))
    assert rp["planned_segments"] == rp["segments"]
    report = render(recs)
    assert f"problem {ck}" in report
    assert "== fleet summary ==" in report
    assert "queries=1" in report
    seg_rows = [ln for ln in report.splitlines()
                if ln.startswith("  refine")]
    assert len(seg_rows) == rp["segments"]
    assert all(float(row.split()[5]) > 0.0 for row in seg_rows)


def test_warm_hit_journals_plan_and_result_only(tmp_path):
    jp = tmp_path / "j.jsonl"
    s = _session(tmp_path, journal=jp)
    q = Query(_problem(), budget=16)
    hit0, miss0 = _counter("explore.cache.hit"), \
        _counter("explore.cache.miss")
    s.submit(q)
    r = s.submit(q)
    assert r.provenance.from_cache
    assert _counter("explore.cache.hit") == hit0 + 1
    assert _counter("explore.cache.miss") == miss0 + 1
    rp = obs.replay(obs.read_journal(jp))[r.provenance.cache_key]
    assert len(rp["results"]) == 2
    assert rp["results"][1]["from_cache"] is True
    assert rp["plans"][-1]["cache_hit"] is True
    assert not rp["plans"][-1]["segments"]


# ---------------------------------------------------------------------------
# journal wiring: Session(journal=...), $REPRO_JOURNAL_DIR
# ---------------------------------------------------------------------------
def test_env_var_enables_default_journal(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.JOURNAL_ENV, str(tmp_path / "fleet"))
    s = _session(tmp_path, journal=None)
    s.submit(Query(_problem(), budget=16))
    files = list((tmp_path / "fleet").glob("run-*.jsonl"))
    assert len(files) == 1
    assert any(r["type"] == "result" for r in obs.read_journal(files[0]))
    s2 = _session(tmp_path / "b", journal=False)
    s2.submit(Query(_problem(96), budget=16))
    recs = list(obs.read_journal(files[0]))
    assert all(r.get("key") != s2._cache_key(_problem(96))
               for r in recs if r["type"] == "result")


def test_report_cli_renders_journal(tmp_path, capsys):
    jp = tmp_path / "j.jsonl"
    s = _session(tmp_path, journal=jp, chunk_generations=2, adaptive=False)
    s.submit(Query(_problem(), budget=32))
    from repro_torch.obs.report import main
    assert main([str(jp)]) == 0
    out = capsys.readouterr().out
    assert "== plan vs actual ==" in out and "refine" in out


# ---------------------------------------------------------------------------
# Plan.predicted_s from the segment-time histograms
# ---------------------------------------------------------------------------
def test_cold_plan_predicts_wall_once_a_segment_has_run(tmp_path,
                                                        monkeypatch):
    fresh = obs.MetricsRegistry()         # a process that ran nothing yet
    monkeypatch.setattr(obs, "REGISTRY", fresh)
    monkeypatch.setattr(obs.trace, "REGISTRY", fresh)
    s = _session(tmp_path, chunk_generations=2, adaptive=False)
    q = Query(_problem(), budget=32)
    assert s.plan(q).predicted_s is None
    s.submit(q)
    cold = s.plan(Query(_problem(96), budget=32))
    seg = fresh.peek("explore.segment_s")
    comp = fresh.peek("explore.segment_compile_s")
    assert cold.predicted_s is not None and cold.predicted_s > 0.0
    # the reference's estimate: first segment at the first-run median when
    # the variant has not run (here it has: same pop, chunk and bounds)
    steady = (seg.quantile(0.5) if seg is not None
              else comp.quantile(0.5))
    assert cold.predicted_s == pytest.approx(2 * steady)


# ---------------------------------------------------------------------------
# journals across the two packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both_journals(tmp_path_factory):
    """One NSGA query (budget 32, pop 8, two segments) submitted to the
    reference and to the port, each with a journal."""
    root = tmp_path_factory.mktemp("xjournal")
    policy_kw = dict(chunk_generations=2, adaptive=False)
    rp = RefProblem(RC.WorkloadGraph([RC.matmul("mm", 512, 512, 64)], []),
                    objectives=OBJ, ch_max=2, space_kwargs=TINY)
    rs = RefSession(cache_dir=root / "ref", journal=root / "ref.jsonl",
                    nsga=RefNSGAConfig(pop=8, generations=2),
                    policy=RefBudgetPolicy(**policy_kw))
    r_ref = rs.submit(RefQuery(rp, budget=32))
    s = Session(cache_dir=root / "port", journal=root / "port.jsonl",
                nsga=NSGAConfig(pop=8, generations=2),
                policy=BudgetPolicy(**policy_kw), device="cpu")
    r_port = s.submit(Query(_problem(), budget=32))
    return dict(ref=(list(ref_obs.read_journal(root / "ref.jsonl")), r_ref),
                port=(list(obs.read_journal(root / "port.jsonl")), r_port))


def _shape(records):
    """Each record type with the keys it carries; spans and metrics
    snapshots by name."""
    out = {}
    for r in records:
        tag = (r["type"], r.get("name"))
        out.setdefault(tag, set()).update(r)
        if r["type"] == "metrics":
            out.setdefault(("snapshot", None), set()).update(
                k for k in r["snapshot"]
                if k.startswith(("explore.", "session.", "obs.")))
    return out


def test_port_journals_the_reference_record_types_and_keys(both_journals):
    ref, port = (_shape(both_journals[k][0]) for k in ("ref", "port"))
    assert set(port) == set(ref)
    for tag in ref:
        if tag == ("snapshot", None):
            # the port's registry also holds what its other tests counted
            assert ref[tag] <= port[tag]
        else:
            assert port[tag] == ref[tag], tag
    seg = [r for r in both_journals["port"][0] if r["type"] == "segment"]
    assert [r["segment"] for r in seg] == [0, 1]
    assert seg[0]["compile"] in (True, False)
    runs = {r.get("run") for r in both_journals["port"][0]
            if r["type"] in ("plan", "segment", "result")}
    assert len(runs) == 1 and None not in runs


def test_port_journal_replays_through_the_reference(both_journals):
    records, r = both_journals["port"]
    rp = ref_obs.replay(records)[r.provenance.cache_key]
    assert rp["segments"] == r.trace.archive_hv.shape[0] == 2
    assert rp["n_evals"] == r.provenance.n_evals_run == 32
    assert rp["final_hv"] == pytest.approx(float(r.trace.archive_hv[-1, 0]),
                                           rel=1e-9)
    assert rp == obs.replay(records)[r.provenance.cache_key]


def test_reference_journal_replays_and_renders_in_the_port(both_journals):
    records, r = both_journals["ref"]
    ck = r.provenance.cache_key
    rp = obs.replay(records)[ck]
    assert rp["segments"] == r.trace.archive_hv.shape[0]
    assert rp["n_evals"] == r.provenance.n_evals_run
    assert rp["final_hv"] == pytest.approx(float(r.trace.archive_hv[-1, 0]))
    assert render(records) == ref_render(records)
    assert f"problem {ck}" in render(records)
