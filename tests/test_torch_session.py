"""The port's front door end to end on the CPU (``repro_torch.api``).

* ``Session(device="cpu").submit`` runs the NSGA search path on BERT-large
  att2 and returns a finite, feasible, nondominated front;
* a second submit (same session, and a fresh session on the same cache
  directory) is served from cache with the identical front;
* options that are not ported raise ``NotImplementedError``;
* ``Session()`` without ``device=`` refuses to run on a card-less host;
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

from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as tp
from repro_torch.core.encoding import feasibility_penalty
from repro_torch.core.evaluate import evaluate_system
from repro_torch.core.optimizer import metric_stack
from repro_torch.explore.archive import (HV_LOG_REF, hypervolume_2d,
                                         pareto_front)
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
    ("bo_sa engine", lambda s, p: s.submit(Query(p, engine="bo_sa"))),
    ("weights", lambda s, p: s.submit(Query(p, weights=(1, 1, 0, 0)))),
    ("two_stage", lambda s, p: s.submit(Query(p, engine="two_stage"))),
    ("transfer", lambda s, p: s.submit(Query(p, transfer=True))),
    ("seeds", lambda s, p: s.submit(Query(p, seed_designs=[{}]))),
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
    with pytest.raises(NotImplementedError, match="not ported"):
        call(s, _problem())
    assert not list(tmp_path.glob("*.npz"))        # nothing ran


def test_session_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(cache_dir=tmp_path)


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
