"""The port's front door end to end on the CPU (``repro_torch.api``).

* ``Session(device="cpu").submit`` runs the NSGA search path on BERT-large
  att2 and returns a finite, feasible, nondominated front;
* a second submit (same session, and a fresh session on the same cache
  directory) is served from cache with the identical front;
* options that are not ported raise ``NotImplementedError``;
* ``Session()`` without ``device=`` refuses to run on a card-less host;
* the scalarized engines (``bo_sa``, ``two_stage``) answer through the
  same ``submit``: ``best_*``, provenance, one completion event, the
  ``Query.archive`` front, mixed batches with ``nsga``, and the reference's
  ``ValueError`` for nsga-only options;
* a statistical gate against the JAX reference: over 3 fixed seeds at
  pop 16 and budget 256, the port's mean front hypervolume is at least
  0.95x the reference's on the same problem.  The two packages draw from
  different random streams, so the gate is statistical, not bitwise.
"""

import jax
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as C
from repro.explore.nsga import NSGAConfig as RefNSGAConfig

from repro_torch import convert
from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as tp
from repro_torch.core.baselines import make_baseline
from repro_torch.core.encoding import feasibility_penalty, random_design
from repro_torch.core.evaluate import evaluate_system
from repro_torch.core.optimizer import (METRIC_KEYS, OBJ_EDP, SAConfig,
                                        decode_bo, make_sa, metric_stack)
from repro_torch.explore.archive import (HV_LOG_REF, ParetoArchive,
                                         hypervolume_2d, pareto_front)
from repro_torch.explore.nsga import NSGAConfig
from repro_torch.explore.service import BudgetPolicy, ExplorationService

OBJ = ("latency_ns", "cost_usd")


def _problem():
    return Problem(tp.bert_mms()["att2"], OBJ, ch_max=4)


def _hv(front_objs):
    return hypervolume_2d(np.log(np.maximum(front_objs, 1e-3)),
                          (HV_LOG_REF, HV_LOG_REF))


def test_submit_end_to_end_on_cpu(tmp_path):
    p = _problem()
    events = []
    r = Session(cache_dir=tmp_path, device="cpu").submit(
        Query(p, budget=256), key=3, on_segment=events.append)
    pv = r.provenance
    assert not pv.from_cache and pv.n_evals_run == 256
    assert r.trace.generations == 4 and r.trace.n_evals[-1] == 256
    assert [e.segment for e in events] == [0]
    assert r.trace.archive_hv.shape == (1, 1)
    fr = r.front_objs
    assert fr.shape[0] >= 1 and fr.shape[1] == 2 and np.all(np.isfinite(fr))
    assert pareto_front(fr) == list(range(len(fr)))       # nondominated
    designs = {k: torch.as_tensor(np.stack([d[k] for d in r.front_designs]))
               for k in r.front_designs[0]}
    m = evaluate_system(p.spec, designs)
    assert float(feasibility_penalty(p.space, designs, m).max()) <= 1 + 1e-6
    np.testing.assert_allclose(metric_stack(m).double().numpy(),
                               r.front_metrics, rtol=1e-6)
    assert (tmp_path / f"{pv.cache_key}.npz").exists()


def test_second_submit_is_served_from_cache(tmp_path):
    q = Query(_problem(), budget=128)
    s = Session(cache_dir=tmp_path, device="cpu")
    cold = s.submit(q)
    for again in (s.submit(q),
                  Session(cache_dir=tmp_path, device="cpu").submit(q)):
        assert again.provenance.from_cache
        assert again.provenance.n_evals_run == 0 and again.trace is None
        np.testing.assert_array_equal(again.front_objs, cold.front_objs)
        np.testing.assert_array_equal(again.front_metrics,
                                      cold.front_metrics)
    # a bigger budget is not covered: it refines the cached archive
    more = s.submit(Query(_problem(), budget=256))
    assert not more.provenance.from_cache and more.provenance.n_evals_run


def test_damaged_cache_file_is_discarded_not_fatal(tmp_path):
    q = Query(_problem(), budget=64)
    key = Session(cache_dir=tmp_path, device="cpu").submit(q) \
        .provenance.cache_key
    path = tmp_path / f"{key}.npz"
    path.write_bytes(path.read_bytes()[:100])       # a truncated write
    with pytest.warns(UserWarning, match="discarding unreadable"):
        r = Session(cache_dir=tmp_path, device="cpu").submit(q)
    assert not r.provenance.from_cache and r.provenance.n_evals_run == 64
    assert len(r.front_objs)


def test_same_problem_queries_share_one_run(tmp_path):
    a = Query(Problem(tp.bert_mms()["att2"], ("latency_ns", "cost_usd")),
              budget=64)
    b = Query(Problem(tp.bert_mms()["att2"], ("energy_pj",)), budget=128)
    ra, rb = Session(cache_dir=tmp_path, device="cpu").submit([a, b])
    assert ra.provenance.cache_key == rb.provenance.cache_key
    assert ra.provenance.n_evals_run == rb.provenance.n_evals_run == 128
    assert ra.trace.objectives == ("latency_ns", "energy_pj", "cost_usd")
    assert rb.front_objs.shape[1] == 1


UNPORTED = [
    ("bo_sa seed_designs", lambda s, p: s.submit(
        Query(p, engine="bo_sa", seed_designs=[{}]))),
    ("bo_sa tech", lambda s, p: s.submit(Query(p, weights=(1, 1, 0, 0),
                                               tech="calibrated"))),
    ("two_stage tech", lambda s, p: s.submit(Query(p, engine="two_stage",
                                                   tech="calibrated"))),
    ("transfer", lambda s, p: s.submit(Query(p, transfer=True))),
    ("two_stage seed_designs", lambda s, p: s.submit(
        Query(p, engine="two_stage", seed_designs=[{}]))),
    ("surrogate", lambda s, p: s.submit(
        Query(p, engine_opts={"surrogate": True}))),
    ("query tech", lambda s, p: s.submit(Query(p, tech="calibrated"))),
    ("resume", lambda s, p: s.submit(Query(p), resume=True)),
    ("control", lambda s, p: s.submit(Query(p), control=object())),
    ("plan", lambda s, p: s.plan(Query(p))),
    ("submit_async", lambda s, p: s.submit_async(Query(p))),
    ("reallocate", lambda s, p: BudgetPolicy(reallocate=True)),
    ("megabatch", lambda s, p: BudgetPolicy(megabatch=True)),
    ("journal", lambda s, p: Session(journal="j.jsonl", device="cpu")),
    ("tech preset", lambda s, p: ExplorationService(tech="preset",
                                                    device="cpu")),
]


@pytest.mark.parametrize("what,call", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_options_raise(tmp_path, what, call):
    s = Session(cache_dir=tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported") as e:
        call(s, _problem())
    assert what.split()[-1] in str(e.value)       # the error names it
    assert not list(tmp_path.glob("*.npz"))        # nothing ran


BO_SA = dict(n_init=2, n_iter=2, sa=SAConfig(steps=6, chains=2))
TWO_STAGE = dict(n_candidates=2, sa=SAConfig(steps=3, chains=2))


def _scalar_problem():
    # ch_max=36: every chiplet count of att2's one workload is placeable,
    # so short runs find feasible designs for the archive
    return Problem(tp.bert_mms()["att2"], ("latency_ns", "energy_pj"),
                   ch_max=36)


def _check_best(p, r):
    d = {k: torch.as_tensor(v)[None] for k, v in r.best_design.items()}
    m = evaluate_system(p.spec, d)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(m[k][0]), float(r.best_metrics[k]),
                                   rtol=1e-6)
    assert np.isfinite(r.best_objective)
    best = r.trace.best
    assert np.all(np.isfinite(best)) and np.all(np.diff(best) <= 0)
    assert best[-1] == pytest.approx(r.best_objective)


@pytest.mark.parametrize("engine,opts,rounds", [
    ("bo_sa", BO_SA, 4), ("two_stage", TWO_STAGE, 6)])
def test_scalarized_engines_answer(tmp_path, engine, opts, rounds):
    p = _scalar_problem()
    events = []
    r = Session(cache_dir=tmp_path, device="cpu").submit(
        Query(p, engine=engine, weights=OBJ_EDP, engine_opts=opts),
        key=1, on_segment=events.append)
    pv = r.provenance
    steps = opts["sa"].steps * opts["sa"].chains
    assert pv.engine == engine and not pv.from_cache
    assert pv.n_evals_run == rounds * steps == r.trace.n_evals[-1]
    assert [(e.segment, e.phase) for e in events] == [(0, engine)]
    assert events[0].trace is r.trace
    _check_best(p, r)
    # no archive: the front is the single incumbent
    assert r.front_objs.shape == (1, 2)
    np.testing.assert_allclose(
        r.front_objs[0], [float(r.best_metrics[k]) for k in p.objectives])
    assert not list(tmp_path.glob("*.npz"))   # never touches the cache


def test_query_archive_is_filled_and_served(tmp_path):
    p = _scalar_problem()
    arc = ParetoArchive(64, random_design(0, p.space, device="cpu"),
                        obj_keys=METRIC_KEYS, device="cpu")
    r = Session(cache_dir=tmp_path, device="cpu").submit(
        Query(p, engine="bo_sa", weights=OBJ_EDP, engine_opts=BO_SA,
              archive=arc), key=2)
    assert len(arc) >= 1 and arc.n_evals == 4   # one row per SA run
    designs, metrics = arc.front()
    keep = pareto_front(metrics[:, [0, 1]])
    np.testing.assert_array_equal(r.front_metrics, metrics[keep])
    assert len(r.front_designs) == len(keep)
    d = {k: torch.as_tensor(np.stack([x[k] for x in r.front_designs]))
         for k in r.front_designs[0]}
    m = evaluate_system(p.spec, d)
    assert float(feasibility_penalty(p.space, d, m).max()) <= 1 + 1e-6
    np.testing.assert_allclose(metric_stack(m).double().numpy(),
                               r.front_metrics, rtol=1e-6)


def test_mixed_batch_answers_both(tmp_path):
    a = Query(_problem(), budget=64)
    b = Query(_scalar_problem(), engine="bo_sa", weights=OBJ_EDP,
              engine_opts=BO_SA)
    ra, rb = Session(cache_dir=tmp_path, device="cpu").submit([a, b])
    assert ra.provenance.engine == "nsga" and ra.provenance.n_evals_run
    assert rb.provenance.engine == "bo_sa" and rb.best_design is not None
    assert ra.best_design is None


@pytest.mark.parametrize("kw", [dict(transfer=True),
                                dict(policy=BudgetPolicy()),
                                dict(engine_opts={"surrogate": True})],
                         ids=["transfer", "policy", "nsga option"])
def test_scalarized_rejects_nsga_options(tmp_path, kw):
    s = Session(cache_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError):
        s.submit(Query(_scalar_problem(), engine="bo_sa", weights=OBJ_EDP,
                       **kw))


@pytest.mark.parametrize("kw", [dict(weights=OBJ_EDP),
                                dict(engine_opts=BO_SA)],
                         ids=["weights", "engine_opts"])
def test_nsga_rejects_scalarized_options(tmp_path, kw):
    with pytest.raises(ValueError):
        Session(cache_dir=tmp_path, device="cpu").submit(
            Query(_problem(), engine="nsga", **kw))


def test_session_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(cache_dir=tmp_path)


ON_THE_CARD = [
    ("design_to_torch", lambda p: convert.design_to_torch(
        {"shape": np.ones((1, 6))})),
    ("make_sa", lambda p: make_sa(p.spec, p.space)),
    ("make_baseline", lambda p: make_baseline("simba", p.spec, 0)),
    ("decode_bo", lambda p: decode_bo(
        p.space, np.zeros(2), random_design(0, p.space, device="cpu"),
        ("packaging", "family"))),
]


@pytest.mark.parametrize("what,call", ON_THE_CARD,
                         ids=[c[0] for c in ON_THE_CARD])
def test_entry_points_default_to_the_card(what, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(_scalar_problem())


def test_front_hypervolume_gate_against_reference(tmp_path):
    seeds = (0, 1, 2)
    graph = C.presets.bert_mms()["att2"]
    ref_hv, port_hv = [], []
    for s in seeds:
        ref = ref_api.Session(cache_dir=tmp_path / f"ref{s}",
                              nsga=RefNSGAConfig(pop=16))
        r = ref.submit(ref_api.Query(ref_api.Problem(graph, OBJ, ch_max=4),
                                     budget=256, engine="nsga"),
                       key=jax.random.PRNGKey(s))
        ref_hv.append(_hv(r.front_objs))
        port = Session(cache_dir=tmp_path / f"port{s}", device="cpu",
                       nsga=NSGAConfig(pop=16))
        pr = port.submit(Query(_problem(), budget=256), key=s)
        assert pr.provenance.n_evals_run == r.provenance.n_evals_run == 256
        port_hv.append(_hv(pr.front_objs))
    assert np.mean(port_hv) >= 0.95 * np.mean(ref_hv), (port_hv, ref_hv)
