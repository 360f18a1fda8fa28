"""The port's fleet cache end to end (case for case the reference's
``tests/test_fleet_cache.py``): one service cold-explores several
``workload_library`` graphs, then refines some of them warm with transfer,
exercising the manifest growth policy (size bound, LRU eviction order), the
trust table's save/load round trip and the transfer / ledger accounting
against a real on-disk cache directory.

Beyond the reference's cases: two ``multiprocessing`` (spawn) services
committing to one cache directory at once lose no manifest entry and leave
loadable archives; an interrupted, resumed query lands on the
bit-identical front of an uninterrupted one; ``export_rows`` /
``flatten_design``, the manifest's ``export_index`` and ``reap_evicted``
against the reference's; ``refresh_archive`` and the ``explore_batch``
shim."""

import multiprocessing as mp
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.api import Problem, Query, RunControl, Session
from repro_torch.core import presets as P
from repro_torch.explore.archive import (MANIFEST_NAME, ArchiveManifest,
                                         ManifestPolicy, ParetoArchive)
from repro_torch.explore.nsga import NSGAConfig
from repro_torch.explore.service import BudgetPolicy, ExplorationService

pytestmark = pytest.mark.filterwarnings("ignore:legacy entry point")

SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")
COLD = ("attn_qwen2_72b", "attn_qwen2_5_32b", "attn_internlm2",
        "mlp_qwen2_72b")
WARM = ("attn_qwen2_72b", "attn_internlm2")
MAX_ENTRIES = 3


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """One shared fleet run: 4 cold explorations, then 2 warm transfer
    refinements, against a bounded manifest."""
    cache = tmp_path_factory.mktemp("fleet_cache")
    lib = P.workload_library()
    svc = ExplorationService(
        cache_dir=cache, nsga=NSGAConfig(pop=8, generations=2),
        policy=BudgetPolicy(adaptive=False, reallocate=False),
        manifest_policy=ManifestPolicy(max_entries=MAX_ENTRIES),
        device="cpu")
    cold = {name: svc.explore(lib[name], OBJ, budget=16, ch_max=2,
                              space_kwargs=SPACE_KW) for name in COLD}
    warm = {name: svc.explore(lib[name], OBJ, budget=48, ch_max=2,
                              space_kwargs=SPACE_KW, transfer=True)
            for name in WARM}
    return dict(cache=cache, svc=svc, cold=cold, warm=warm)


def test_every_query_ran_and_archives_persisted(fleet):
    svc = fleet["svc"]
    for r in fleet["cold"].values():
        assert not r.from_cache and r.n_evals_run >= 16
        assert len(r.front_objs) >= 1
        assert svc._path(r.cache_key).exists()
    for name, r in fleet["warm"].items():
        assert not r.from_cache and r.n_evals_run >= 32
        assert r.cache_key == fleet["cold"][name].cache_key


def test_manifest_stays_within_bound_with_no_query_errors(fleet):
    svc = fleet["svc"]
    assert len(svc.manifest) <= MAX_ENTRIES
    any_key = next(iter(svc.manifest.entries))
    emb = svc.manifest.entries[any_key]["embedding"]
    got = svc.manifest.nearest(emb, k=10)
    assert 1 <= len(got) <= MAX_ENTRIES
    for nk, _ in got:
        assert svc.manifest.entries[nk]["digest"] is not None


def test_eviction_order_is_lru(fleet):
    svc = fleet["svc"]
    live = {k: e.get("last_used", 0)
            for k, e in svc.manifest.entries.items()}
    assert fleet["warm"][WARM[-1]].cache_key in live
    evicted = [r.cache_key for r in fleet["cold"].values()
               if r.cache_key not in live]
    assert len(evicted) >= 1
    for ck in evicted:                   # eviction bounds the index only
        assert svc._path(ck).exists()


def test_trust_table_roundtrips_through_save_load(fleet):
    svc = fleet["svc"]
    trust = svc.manifest.trust
    assert len(trust) >= 1
    for r in trust:
        assert 0.0 <= r["lift"] <= 1.0
        assert np.all(np.isfinite(r["delta"]))
    back = ArchiveManifest.load(fleet["cache"] / MANIFEST_NAME)
    assert len(back.trust) == len(trust)
    for a, b in zip(trust, back.trust):
        assert (a["src"], a["dst"]) == (b["src"], b["dst"])
        assert a["lift"] == pytest.approx(b["lift"])
        np.testing.assert_allclose(a["delta"], b["delta"])
    assert back.clock == svc.manifest.clock >= len(COLD)


def test_transfer_accounting_consistent_with_ledger(fleet):
    svc = fleet["svc"]
    for r in fleet["cold"].values():
        assert r.transferred_from == () and r.n_transfer_seeds == 0
    for r in fleet["warm"].values():
        assert (len(r.transferred_from) >= 1) == (r.n_transfer_seeds >= 1)
        assert r.cache_key not in r.transferred_from
        for nk in r.transferred_from:
            assert any(t["src"] == nk and t["dst"] == r.cache_key
                       for t in svc.manifest.trust)
    for r in list(fleet["cold"].values()) + list(fleet["warm"].values()):
        assert not r.plateaued and r.n_evals_banked == 0
        assert r.n_evals_realloc == 0
    assert svc.ledger == {}


# ---------------------------------------------------------------------------
# two processes, one cache directory
# ---------------------------------------------------------------------------
def _commit(cache: str, name: str, src: str, barrier) -> str:
    """One spawned service: wait for its peer, then run one transfer query
    into the shared cache directory.  Returns the archive key."""
    sys.path.insert(0, src)
    from repro_torch.api import Problem as Pr, Query as Q, Session as S
    from repro_torch.core import presets as pr
    from repro_torch.explore.nsga import NSGAConfig as N
    s = S(cache_dir=cache, device="cpu", nsga=N(pop=8))
    q = Q(Pr(pr.workload_library()[name], OBJ, ch_max=2,
             space_kwargs=SPACE_KW), budget=16, transfer=True)
    barrier.wait()
    return s.submit(q).provenance.cache_key


def test_two_spawned_services_lose_no_manifest_entry(tmp_path):
    names = ("attn_qwen2_72b", "mlp_qwen2_72b")
    src = str(Path(__file__).resolve().parents[1] / "src")
    ctx = mp.get_context("spawn")
    with ctx.Manager() as mgr:
        barrier = mgr.Barrier(len(names))
        with ctx.Pool(len(names)) as pool:
            keys = pool.starmap(_commit, [(str(tmp_path), n, src, barrier)
                                          for n in names])
    assert len(set(keys)) == 2
    m = ArchiveManifest.load(tmp_path / MANIFEST_NAME)
    assert set(keys) <= set(m.entries)            # no lost update
    for k in keys:
        assert m.entries[k]["digest"] is not None
        assert len(ParetoArchive.load(tmp_path / f"{k}.npz",
                                      device="cpu")) >= 1
    # a third service plans a transfer from what both committed
    third = Session(cache_dir=tmp_path, device="cpu", nsga=NSGAConfig(pop=8))
    q = Query(Problem(P.workload_library()["attn_internlm2"], OBJ, ch_max=2,
                      space_kwargs=SPACE_KW), budget=16, transfer=True)
    plan = third.plan(q)
    assert {n.key for n in plan.neighbors} == set(keys)
    assert all(n.quota >= 1 for n in plan.neighbors)
    r = third.submit(q)
    assert set(r.provenance.transferred_from) <= set(keys)
    assert len(r.provenance.transferred_from) >= 1


# ---------------------------------------------------------------------------
# interrupt and resume
# ---------------------------------------------------------------------------
def _resume_session(cache):
    return Session(cache_dir=cache, device="cpu", nsga=NSGAConfig(pop=8),
                   policy=BudgetPolicy(chunk_generations=2, adaptive=False))


def test_interrupted_then_resumed_run_is_bit_identical(tmp_path):
    q = Query(Problem(P.transformer_block(), OBJ, ch_max=2,
                      space_kwargs=SPACE_KW), budget=64)
    full = _resume_session(tmp_path / "full").submit(q, key=3)
    ctl, seen = RunControl(), []

    def stop_after_two(ev):
        seen.append(ev.segment)
        if len(seen) == 2:
            ctl.stop()
    cut = _resume_session(tmp_path / "cut").submit(
        q, key=3, on_segment=stop_after_two, resume=True, control=ctl)
    pv = cut.provenance
    assert pv.interrupted and seen == [0, 1]
    ck = pv.cache_key
    assert (tmp_path / "cut" / f"{ck}.ckpt.npz").exists()
    # a fresh session resumes from the checkpoint: the residual spend only
    rest = _resume_session(tmp_path / "cut").submit(q, key=3, resume=True)
    assert not rest.provenance.interrupted and not rest.provenance.from_cache
    assert pv.n_evals_run + rest.provenance.n_evals_run \
        == full.provenance.n_evals_run == 64
    assert not (tmp_path / "cut" / f"{ck}.ckpt.npz").exists()
    np.testing.assert_array_equal(rest.front_objs, full.front_objs)
    np.testing.assert_array_equal(rest.front_metrics, full.front_metrics)
    for a, b in zip(rest.front_designs, full.front_designs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(rest.trace.archive_hv,
                                  full.trace.archive_hv)
    np.testing.assert_array_equal(rest.trace.hypervolume,
                                  full.trace.hypervolume)


def test_resume_ignores_a_checkpoint_of_another_run(tmp_path):
    q = Query(Problem(P.transformer_block(), OBJ, ch_max=2,
                      space_kwargs=SPACE_KW), budget=64)
    ctl = RunControl()
    cut = _resume_session(tmp_path).submit(
        q, key=3, on_segment=lambda ev: ctl.stop(), resume=True, control=ctl)
    assert cut.provenance.interrupted and cut.provenance.n_evals_run == 16
    ckpt = tmp_path / f"{cut.provenance.cache_key}.ckpt.npz"
    assert ckpt.exists()
    # another key is another numeric stream: its signature does not match,
    # so the whole budget is spent from the archive's state, not spliced
    other = _resume_session(tmp_path).submit(q, key=4, resume=True)
    assert other.provenance.n_evals_run == 64
    assert not other.provenance.interrupted and not ckpt.exists()


# ---------------------------------------------------------------------------
# the rest of the shared-cache surface
# ---------------------------------------------------------------------------
def test_export_rows_follow_flatten_design_and_match_the_reference():
    from repro.explore import archive as ref_arc
    from repro_torch.explore.archive import design_encoding_dim, flatten_design
    rng = np.random.default_rng(3)
    template = {"b": np.zeros((2,), np.int32), "a": np.zeros((), np.int32)}
    arc = ParetoArchive(16, template, n_obj=2, device="cpu")
    X0, Y0 = arc.export_rows()
    assert design_encoding_dim(template) == 3
    assert X0.shape == (0, 3) and Y0.shape == (0, 2)
    designs = {"b": rng.integers(0, 9, (12, 2)), "a": rng.integers(0, 9, 12)}
    arc.insert(designs, rng.integers(0, 20, (12, 2)).astype(np.float32))
    X, Y = arc.export_rows()
    front, objs = arc.front()
    np.testing.assert_array_equal(Y, objs)
    for i in range(len(objs)):
        row = flatten_design({k: v[i] for k, v in front.items()})
        np.testing.assert_array_equal(X[i], row.numpy())
    # the reference's archive holding the same rows exports the same matrix
    ref = ref_arc.ParetoArchive(16, template, n_obj=2)
    ref.objs[:len(objs)] = objs
    ref.valid[:len(objs)] = True
    for k in front:
        ref.designs[k][:len(objs)] = front[k]
    RX, RY = ref.export_rows()
    np.testing.assert_array_equal(X, RX)
    np.testing.assert_array_equal(Y, RY)


def test_refresh_archive_merges_a_peers_rows(tmp_path):
    p = Problem(P.workload_library()["attn_internlm2"], OBJ, ch_max=2,
                space_kwargs=SPACE_KW)
    a = Session(cache_dir=tmp_path, device="cpu", nsga=NSGAConfig(pop=8))
    b = Session(cache_dir=tmp_path, device="cpu", nsga=NSGAConfig(pop=8))
    stale = b.service.archive_for(p.spec, p.space)
    assert len(stale) == 0
    a.submit(Query(p, budget=16))
    written = a.service.archive_for(p.spec, p.space)
    fresh = b.service.refresh_archive(p.spec, p.space)
    assert fresh is stale and len(fresh) == len(written) >= 1
    assert fresh.n_evals == 16 and set(fresh.searched) == set(OBJ)
    np.testing.assert_array_equal(np.sort(fresh.front()[1], axis=0),
                                  np.sort(written.front()[1], axis=0))


def test_explore_batch_shim_answers_each_query(tmp_path):
    from repro_torch.explore.service import ExploreQuery
    lib = P.workload_library()
    svc = ExplorationService(cache_dir=tmp_path, device="cpu",
                             nsga=NSGAConfig(pop=8))
    qs = [ExploreQuery(lib["attn_internlm2"], OBJ, 16, 2, SPACE_KW),
          ExploreQuery(lib["attn_internlm2"], ("energy_pj",), 32, 2,
                       SPACE_KW),
          ExploreQuery(lib["mlp_qwen2_72b"], OBJ, 16, 2, SPACE_KW,
                       transfer=True)]
    with pytest.warns(DeprecationWarning, match="legacy entry point"):
        ra, rb, rc = svc.explore_batch(qs)
    assert ra.cache_key == rb.cache_key != rc.cache_key
    assert ra.n_evals_run == rb.n_evals_run == 32       # one merged run
    assert rc.transferred_from == (ra.cache_key,)


def test_manifest_export_index_and_reap_match_the_reference(tmp_path):
    from repro.explore import archive as ref_arc
    ms = []
    for mod in (ref_arc, None):
        m = (ArchiveManifest(tmp_path / "port.npz",
                             ManifestPolicy(max_entries=2,
                                            reap_evicted_after=1))
             if mod is None else
             ref_arc.ArchiveManifest(tmp_path / "ref.npz",
                                     ref_arc.ManifestPolicy(
                                         max_entries=2,
                                         reap_evicted_after=1)))
        for i, (n, digest) in enumerate([(4, {"i": 0}), (0, {"i": 1}),
                                         (8, None), (2, {"i": 3})]):
            m.update(f"k{i}", np.full(3, float(i)), (1, 2, 1), n, n, (),
                     digest=digest)
        ms.append(m)
    ref, port = ms
    got, want = port.export_index(), ref.export_index()
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.evicted == ref.evicted
    for k in ("k0", "k1", "k2", "k3"):
        (tmp_path / f"{k}.npz").write_bytes(b"x")
    port.touch("k3")
    assert port.reap_evicted(tmp_path) == ("k0", "k1")
    assert not (tmp_path / "k0.npz").exists()
    assert (tmp_path / "k2.npz").exists() and (tmp_path / "k3.npz").exists()
