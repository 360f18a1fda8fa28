"""Surrogate-gated evaluation in the port (``repro_torch.explore.
surrogate`` and the service / api wiring), mirroring ``tests/
test_surrogate.py`` case for case — dataset layout, degenerate fits, the
off / cold bit-identity contract, realized savings, the disagreement
fallback, the non-linear trust head — and held against the JAX package on
the same numpy inputs: harvested rows, the ensemble fit from the same
initial weights and bootstrap rows, predictions, disagreement and the
gate's chosen slots under the same weights.  Small sizes, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.explore import archive as ref_archive
from repro.explore import surrogate as ref_sur

from repro_torch import convert
from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as tp
from repro_torch.core.encoding import DesignSpace, random_design
from repro_torch.core.evaluate import SystemSpec
from repro_torch.explore import quantize
from repro_torch.explore.archive import (ArchiveManifest, ParetoArchive,
                                         design_encoding_dim, flatten_design,
                                         flatten_rows)
from repro_torch.explore.nsga import gate_candidates
from repro_torch.explore.service import (BudgetPolicy, ExplorationService,
                                         ExploreQuery, RunControl)
from repro_torch.explore.surrogate import (NONLINEAR_TRUST_MIN,
                                           NonlinearTrustModel,
                                           SurrogateConfig, _fit_ensemble,
                                           ensemble_forward,
                                           fit_nonlinear_trust,
                                           fit_surrogate, harvest_rows)

TINY_SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")
# a fit from the same weights and rows: float32 sums in another order over
# 300 Adam steps (measured max abs ~4e-6 on outputs of scale ~0.8)
FIT_ATOL, FIT_RTOL = 1e-4, 1e-3


def _graph():
    return tp.bert_mms()["att2"]


def _svc(tmp_path, name="c", chunk=8):
    return ExplorationService(cache_dir=tmp_path / name, capacity=128,
                              policy=BudgetPolicy(adaptive=False,
                                                  chunk_generations=chunk),
                              device="cpu")


def _query(budget=64, surrogate=None):
    return ExploreQuery(_graph(), OBJ, budget=budget, ch_max=2,
                        space_kwargs=TINY_SPACE_KW, surrogate=surrogate)


GATED = {"min_rows": 8, "epochs": 60}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The fits are thousands of tiny CPU ops: under a parallel test run
    (several worker processes, each with a thread per core) intra-op
    threads only contend, so this module runs them on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# dataset export: flatten_design <-> export_rows layout
# ---------------------------------------------------------------------------
def test_export_rows_matches_flatten_design_layout(tmp_path):
    svc = _svc(tmp_path)
    svc.run_queries([_query(budget=32)], key=0)
    arc = next(iter(svc._archives.values()))
    X, Y = arc.export_rows()
    valid = np.flatnonzero(arc.valid.numpy())
    template = {k: v[0] for k, v in arc.designs.items()}
    assert X.shape == (len(valid), design_encoding_dim(template))
    assert Y.shape == (X.shape[0], 4)
    assert np.all(np.isfinite(X)) and np.all(np.isfinite(Y))
    # row i is exactly flatten_design of valid entry i — the gated run
    # encodes candidates with flatten_rows, the same layout
    for row, i in zip(X[:4], valid[:4]):
        d = {k: v[i] for k, v in arc.designs.items()}
        np.testing.assert_allclose(row, flatten_design(d).numpy(),
                                   rtol=1e-6)
    np.testing.assert_array_equal(
        X, flatten_rows({k: v[torch.as_tensor(valid)]
                         for k, v in arc.designs.items()}).numpy())


def test_export_rows_empty_archive(tmp_path):
    svc = _svc(tmp_path)
    spec = SystemSpec.build(_graph(), ch_max=2)
    arc = svc.archive_for(spec, DesignSpace(spec, **TINY_SPACE_KW))
    X, Y = arc.export_rows()
    assert X.shape[0] == 0 and Y.shape == (0, 4)
    assert X.shape[1] == design_encoding_dim(
        {k: v[0] for k, v in arc.designs.items()})


# ---------------------------------------------------------------------------
# fitting degeneracies
# ---------------------------------------------------------------------------
def test_fit_surrogate_below_min_rows_returns_none():
    rng = np.random.default_rng(0)
    X = rng.random((10, 6)).astype(np.float32)
    Y = rng.random((10, 4)) + 0.5
    assert fit_surrogate(X, Y, SurrogateConfig(min_rows=64),
                         device="cpu") is None


def test_fit_surrogate_constant_metric_zero_variance():
    """A constant metric column (zero variance) fits without NaN and
    predicts (approximately) the constant back."""
    rng = np.random.default_rng(1)
    X = rng.random((48, 6)).astype(np.float32)
    Y = np.column_stack([np.full(48, 2.0), 1.0 + rng.random((48, 3))])
    sur = fit_surrogate(X, Y, SurrogateConfig(min_rows=16, epochs=300),
                        device="cpu")
    assert sur is not None
    mean, std = sur.predict(X[:8])
    assert np.all(np.isfinite(mean)) and np.all(np.isfinite(std))
    np.testing.assert_allclose(mean[:, 0], np.log(2.0), atol=0.35)
    assert np.all(std[:, 0] < 0.35)
    assert np.all(np.isfinite(sur.disagreement(X[:8])))


def test_fit_surrogate_drops_nonfinite_rows():
    rng = np.random.default_rng(2)
    X = rng.random((40, 5)).astype(np.float32)
    Y = 1.0 + rng.random((40, 4))
    X[3, 0] = np.nan
    Y[7, 2] = np.inf
    sur = fit_surrogate(X, Y, SurrogateConfig(min_rows=16, epochs=50),
                        device="cpu")
    assert sur is not None and sur.n_rows == 38


def test_surrogate_config_n_exact_bounds():
    cfg = SurrogateConfig(exact_frac=0.5)
    assert cfg.n_exact(16) == 8
    assert cfg.n_exact(1) == 1
    assert SurrogateConfig(exact_frac=0.0).n_exact(16) == 1
    assert SurrogateConfig(exact_frac=1.0).n_exact(16) == 16
    for pop in (1, 7, 32, 64):
        for frac in (0.0, 0.25, 0.5, 0.9):
            assert SurrogateConfig(exact_frac=frac).n_exact(pop) == \
                ref_sur.SurrogateConfig(exact_frac=frac).n_exact(pop)


def test_harvest_rows_skips_mismatched_layouts():
    rows = np.random.default_rng(3).random((6, 10)).astype(np.float32)
    objs = 1.0 + np.random.default_rng(4).random((6, 4))

    class FakeArc:
        def export_rows(self):
            return rows, objs

    index = [("good", np.ones(3)), ("bad_emb", np.ones(5)),
             ("broken", np.ones(3))]
    X, Y = harvest_rows(index,
                        lambda k: None if k == "broken" else FakeArc(),
                        design_dim=10, embed_dim=3)
    assert X.shape == (6, 13) and Y.shape == (6, 4)
    np.testing.assert_allclose(X[:, :10], rows)
    np.testing.assert_allclose(X[:, 10:], 1.0)


# ---------------------------------------------------------------------------
# the off / cold bit-identity contract
# ---------------------------------------------------------------------------
def test_query_surrogate_validation():
    q = _query(surrogate=True)
    assert q.surrogate == {}                # True normalizes to defaults
    with pytest.raises(ValueError, match="surrogate"):
        _query(surrogate="yes")


def test_cold_cache_runs_exact_bit_identical(tmp_path):
    """Surrogate asked for on an EMPTY cache: nothing to fit, so the run is
    byte for byte the surrogate=None run (fronts and spend)."""
    ra, = _svc(tmp_path, "a").run_queries([_query(surrogate=True)], key=0)
    rb, = _svc(tmp_path, "b").run_queries([_query()], key=0)
    assert not ra.surrogate_used and ra.surrogate_hits == 0
    assert ra.n_evals_run == rb.n_evals_run
    np.testing.assert_array_equal(ra.front_objs, rb.front_objs)
    np.testing.assert_array_equal(ra.front_metrics, rb.front_metrics)
    for da, db in zip(ra.front_designs, rb.front_designs):
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])


# ---------------------------------------------------------------------------
# gated refinement through the service
# ---------------------------------------------------------------------------
def test_gated_run_spends_fewer_exact_evals(tmp_path):
    svc = _svc(tmp_path)
    svc.run_queries([_query(budget=64)], key=0)       # training rows
    r, = svc.run_queries([_query(budget=256, surrogate=GATED)], key=7)
    assert r.surrogate_used
    assert r.surrogate_fallbacks == 0
    assert r.surrogate_hits > 0
    # every generation's skipped candidates are exactly the gate's
    # non-exact slots: spent + skipped reconstructs the exact schedule
    sched = quantize.schedule(256, svc.nsga.pop,
                              svc.policy.chunk_generations)
    total = sched.pop * sched.chunk * sched.n_seg
    assert r.n_evals_run + r.surrogate_hits == total
    assert r.n_evals_run < total
    assert len(r.front_objs) > 0
    assert r.trace.n_evals[-1] == r.n_evals_run


def test_disagreement_fallback_abandons_surrogate(tmp_path):
    """``fallback_tau`` below any achievable disagreement: the first gated
    segment trips the fallback and the rest of the run is exact."""
    svc = _svc(tmp_path, chunk=2)
    svc.run_queries([_query(budget=64)], key=0)
    r, = svc.run_queries([_query(budget=256, surrogate=dict(
        GATED, fallback_tau=-1.0))], key=7)
    assert r.surrogate_used and r.surrogate_fallbacks == 1
    gated_all, = svc.run_queries([_query(budget=257, surrogate=GATED)],
                                 key=8)        # distinct budget: a refine
    assert r.surrogate_hits <= gated_all.surrogate_hits
    # only the first 2-generation segment of 4 was gated
    assert r.surrogate_hits == (64 - 32) * 2


def test_gated_resume_is_bit_identical(tmp_path):
    """A gated run stopped after its second segment and resumed in a fresh
    service replays the checkpointed surrogate: the front equals the
    uninterrupted gated run's byte for byte, and the two attempts' exact
    spends and hits sum to the uninterrupted run's."""
    import shutil
    base = _svc(tmp_path, "base", chunk=2)
    base.run_queries([_query(budget=64)], key=0)
    for d in ("full", "stop"):
        shutil.copytree(tmp_path / "base", tmp_path / d)
    q = lambda: _query(budget=512, surrogate=GATED)  # noqa: E731
    full, = _svc(tmp_path, "full", chunk=2).run_queries([q()], key=7,
                                                        resume=True)
    ctl, seen = RunControl(), []

    def stop_after_two(ev):
        seen.append(ev)
        if len(seen) == 2:
            ctl.stop()
    a, = _svc(tmp_path, "stop", chunk=2).run_queries(
        [q()], key=7, resume=True, control=ctl, on_segment=stop_after_two)
    assert a.interrupted and a.surrogate_used
    b, = _svc(tmp_path, "stop", chunk=2).run_queries([q()], key=7,
                                                     resume=True)
    assert not b.interrupted
    assert a.n_evals_run + b.n_evals_run == full.n_evals_run
    assert a.surrogate_hits + b.surrogate_hits == full.surrogate_hits
    np.testing.assert_array_equal(b.front_objs, full.front_objs)
    np.testing.assert_array_equal(b.front_metrics, full.front_metrics)
    for da, db in zip(b.front_designs, full.front_designs):
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])


def test_session_surrogate_engine_opts(tmp_path):
    """``engine_opts={"surrogate": ...}`` through ``Session``: the plan
    predicts the gate's savings, the provenance reports them, and a gated
    query never fuses with others."""
    s = Session(cache_dir=tmp_path, policy=BudgetPolicy(adaptive=False),
                device="cpu")
    prob = Problem(_graph(), OBJ, ch_max=2, space_kwargs=TINY_SPACE_KW)
    s.submit(Query(prob, budget=64), key=0)
    q = Query(prob, budget=256, engine_opts={"surrogate": dict(
        GATED, exact_frac=0.25)})
    plan = s.plan(q)
    assert plan.surrogate and plan.predicted_eval_savings == 48 * 4
    r = s.submit(q, key=3)
    pv = r.provenance
    assert pv.surrogate_used and pv.surrogate_hits == 48 * 4
    assert pv.n_evals_run == 16 * 4 and pv.surrogate_fallbacks == 0
    with pytest.raises(ValueError, match="surrogate"):
        s.submit(Query(prob, engine_opts={"n_init": 3}))


# ---------------------------------------------------------------------------
# the non-linear trust head
# ---------------------------------------------------------------------------
def _trust_records(seed, n=20):
    rng = np.random.default_rng(seed)
    return ([dict(delta=rng.random(4) * 0.1, lift=0.9) for _ in range(n)]
            + [dict(delta=2.0 + rng.random(4), lift=0.05)
               for _ in range(n)])


def test_fit_nonlinear_trust_contract():
    tm = fit_nonlinear_trust(_trust_records(5), epochs=150)
    assert isinstance(tm, NonlinearTrustModel)
    near = tm.predict(np.zeros(4))
    far = tm.predict(np.full(4, 2.5))
    assert near >= 0.0 and far >= 0.0         # clamped at zero
    assert near > far                         # learned the structure
    assert tm.predict(np.zeros(9)) == 0.0     # dim mismatch => neutral


def test_fit_nonlinear_trust_below_min_returns_none():
    records = [dict(delta=np.ones(3), lift=0.5) for _ in range(4)]
    assert fit_nonlinear_trust(records) is None


def test_manifest_trust_model_switches_to_nonlinear():
    rng = np.random.default_rng(6)
    m = ArchiveManifest()
    for i in range(NONLINEAR_TRUST_MIN - 1):
        lift = 0.9 if i % 2 == 0 else 0.1
        delta = (rng.random(4) * 0.1 if i % 2 == 0
                 else 2.0 + rng.random(4))
        m.record_transfer(f"s{i}", "d", delta, lift)
    assert not isinstance(m.trust_model(dim=4), NonlinearTrustModel)
    m.record_transfer("last", "d", rng.random(4) * 0.1, 0.9)
    tm = m.trust_model(dim=4)
    assert isinstance(tm, NonlinearTrustModel)
    assert tm.predict(np.zeros(4)) >= 0.0


# ---------------------------------------------------------------------------
# against the JAX package on the same numpy inputs
# ---------------------------------------------------------------------------
def test_harvest_rows_equal_reference():
    """Two archives holding the same designs and metrics in both packages:
    the harvested X / Y are equal."""
    spec = SystemSpec.build(_graph(), ch_max=2)
    space = DesignSpace(spec, **TINY_SPACE_KW)
    template = random_design(0, space, device="cpu")
    rng = np.random.default_rng(9)
    arcs = {}
    for key, seed in (("a", 1), ("b", 2)):
        d = random_design(seed, space, n=24, device="cpu")
        objs = (1.0 + rng.random((24, 4))).astype(np.float32)
        mine = ParetoArchive(64, template, device="cpu")
        mine.insert(d, torch.as_tensor(objs))
        theirs = ref_archive.ParetoArchive(
            64, {k: v.numpy() for k, v in template.items()})
        theirs.insert({k: v.numpy() for k, v in d.items()}, objs)
        arcs[key] = (mine, theirs)
    index = [("a", np.arange(5.0)), ("b", np.ones(5)), ("c", np.ones(5))]
    dim = design_encoding_dim(template)
    X, Y = harvest_rows(index, lambda k: arcs[k][0] if k in arcs else None,
                        dim, 5)
    Xr, Yr = ref_sur.harvest_rows(
        index, lambda k: arcs[k][1] if k in arcs else None, dim, 5)
    assert len(X) > 0
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(Y, Yr)


def _ref_init(key, members, din, hidden, dout, n):
    k_init, k_boot = jax.random.split(key)
    params = ref_sur._init_params(k_init, members, din, hidden, dout)
    idx = jax.vmap(lambda k: jax.random.randint(k, (n,), 0, n))(
        jax.random.split(k_boot, members))
    return {k: np.asarray(v) for k, v in params.items()}, np.asarray(idx)


@pytest.mark.parametrize("members,hidden,epochs,lr,dout", [
    (4, 48, 300, 3e-3, 4), (2, 16, 300, 1e-2, 1)])
def test_fit_ensemble_matches_reference(members, hidden, epochs, lr, dout):
    """From the reference's initial weights and bootstrap rows, the port's
    Adam loop reaches the same function (atol 1e-4 + rtol 1e-3)."""
    rng = np.random.default_rng(members)
    n, din = 80, 23
    Xn = rng.standard_normal((n, din)).astype(np.float32)
    Yn = rng.standard_normal((n, dout)).astype(np.float32)
    key = jax.random.PRNGKey(members + 10)
    params, idx = _ref_init(key, members, din, hidden, dout, n)
    want = ref_sur._fit_ensemble(Xn, Yn, members, hidden, epochs, lr, key)
    got = _fit_ensemble(Xn, Yn, members, hidden, epochs, lr, 0,
                        device="cpu", params=params, idx=idx)
    Xt = rng.standard_normal((40, din)).astype(np.float32)
    a = np.asarray(ref_sur.ensemble_forward(want, jnp.asarray(Xt)))
    b = ensemble_forward({k: torch.as_tensor(v) for k, v in got.items()},
                         torch.as_tensor(Xt)).numpy()
    np.testing.assert_allclose(b, a, atol=FIT_ATOL, rtol=FIT_RTOL)


def _ref_surrogate(din=30, rows=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((rows, din)).astype(np.float32)
    Y = np.exp(rng.standard_normal((rows, 4)) + X[:, :4])
    return ref_sur.fit_surrogate(X, Y, ref_sur.SurrogateConfig(
        min_rows=16, epochs=40, members=3, hidden=12)), X


def test_predict_and_disagreement_equal_reference():
    ref, X = _ref_surrogate()
    mine = convert.surrogate_from_reference(ref)
    assert mine.digest() == ref.digest()
    m_r, s_r = ref.predict(X[:20])
    m_p, s_p = mine.predict(X[:20])
    np.testing.assert_allclose(m_p, m_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_p, s_r, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(mine.disagreement(X[:20]),
                               ref.disagreement(X[:20]), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("n_exact,beta,tau", [(8, 1.0, 1.0), (4, 1.5, 0.05),
                                              (16, 0.0, 10.0)])
def test_gate_slots_equal_reference(n_exact, beta, tau):
    """Given the same weights and candidates, the gate picks the same
    exact-evaluation slots and forces the same count as the reference's
    gate (its ``_build_run_gated.gate`` math on the reference's
    primitives)."""
    emb_dim = 6
    ref, _ = _ref_surrogate(din=24 + emb_dim, rows=64, seed=n_exact)
    mine = convert.surrogate_from_reference(ref)
    rng = np.random.default_rng(n_exact)
    X = rng.integers(0, 4, size=(32, 24)).astype(np.float32)
    X[16:20] = X[:4]                          # ties in the ranking
    emb = rng.random(emb_dim)
    obj_idx = (0, 3)
    sur = mine.scan_arrays(emb, device="cpu")
    slots, forced, dis = gate_candidates(
        sur, torch.as_tensor(X), torch.as_tensor(obj_idx), n_exact, beta,
        tau)

    r = ref.scan_arrays(emb)
    Xr = jnp.concatenate([jnp.asarray(X), jnp.broadcast_to(
        r["emb"], (32,) + r["emb"].shape)], axis=1)
    out = ref_sur.ensemble_forward({k: r[k] for k in
                                    ("W1", "b1", "W2", "b2", "W3", "b3")},
                                   (Xr - r["x_mean"]) / r["x_std"])
    mean_n, std_n = jnp.mean(out, 0), jnp.std(out, 0)
    dis_r = jnp.mean(std_n, axis=1)
    lcb = (mean_n - beta * std_n)[:, jnp.asarray(obj_idx)]
    ones = jnp.ones((32,), bool)
    score = (ref_archive.dominance_counts(lcb, ones).astype(jnp.float32)
             * 1e6 - jnp.minimum(ref_archive.crowding_distance(lcb, ones),
                                 1e5))
    forced_r = dis_r > tau
    score = jnp.where(forced_r, -ref_archive.BIG, score)
    want = np.asarray(jnp.argsort(score)[:n_exact])
    np.testing.assert_array_equal(slots.numpy(), want)
    assert int(forced) == int(jnp.sum(forced_r))
    np.testing.assert_allclose(float(dis), float(jnp.mean(dis_r)),
                               rtol=1e-5)


def test_nonlinear_trust_equals_reference():
    """The trust head's Adam loop from the reference's initial weights
    reaches the same lifts, and the same weights predict the same lifts."""
    records = _trust_records(11, n=24)
    ref_tm = ref_sur.fit_nonlinear_trust(records, epochs=300)
    mine = convert.surrogate_from_reference(ref_tm)
    rng = np.random.default_rng(12)
    for delta in [np.zeros(4), np.full(4, 2.5), rng.random(4),
                  2.0 * rng.random(4)]:
        assert mine.predict(delta) == pytest.approx(ref_tm.predict(delta),
                                                    rel=1e-5, abs=1e-6)
    X = np.stack([np.abs(r["delta"]) for r in records]).astype(np.float32)
    y = np.asarray([r["lift"] for r in records])[:, None]
    Xn = (X - mine.x_mean) / mine.x_std
    Yn = ((y - mine.y_mean) / mine.y_std).astype(np.float32)
    params, idx = _ref_init(jax.random.PRNGKey(0), 2, 4, 16, 1, len(X))
    got = _fit_ensemble(Xn, Yn, 2, 16, 300, 1e-2, 0, device="cpu",
                        params=params, idx=idx)
    mine.params = got
    for delta in [np.zeros(4), np.full(4, 2.5), rng.random(4)]:
        assert mine.predict(delta) == pytest.approx(
            ref_tm.predict(delta), rel=FIT_RTOL, abs=FIT_ATOL)
