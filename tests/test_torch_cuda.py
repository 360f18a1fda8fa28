"""The port's CUDA paths on the card: each kernel held against its plain
PyTorch version, and the evaluator and a short search on the device.

Marked ``cuda``; every test skips (inside the test) on a host without a
CUDA device.  Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports
no ``jax``: the machine with the card has none."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# pools: the search's, a ragged one, a large one, all invalid, one row;
# then the kernel's edges: its 128-row j tiles (129), its chunks of at
# least 64 dominator rows (65: two chunks), 8 chunks to a cluster (513,
# 8193), staged tiles of 512 rows rounded up to 4 (8193 / 8 per chunk)
@pytest.mark.parametrize("n,k,frac", [(128, 2, 1.0), (768, 4, 1.0),
                                      (190, 3, 0.9), (8192, 4, 0.8),
                                      (256, 4, 0.0), (1, 1, 1.0),
                                      (129, 4, 0.9), (65, 1, 0.7),
                                      (513, 3, 0.9), (8193, 2, 0.9)])
def test_pareto_rank_kernel_matches_plain(cuda, n, k, frac):
    from repro_torch.kernels.pareto_rank import ops
    from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref
    gen = torch.Generator(device=cuda).manual_seed(n * 10 + k)
    objs = torch.randn(n, k, generator=gen, device=cuda)
    dup = min(16, n // 4)
    objs[n // 2:n // 2 + dup] = objs[:dup]
    valid = torch.rand(n, generator=gen, device=cuda) < frac
    before = ops.dominance_counts.launches
    got = ops.dominance_counts(objs, valid)
    torch.cuda.synchronize()
    assert ops.dominance_counts.launches == before + 1
    assert torch.equal(got, dominance_counts_ref(objs, valid))


def _special_pool(n, k, frac, values, dev, seed):
    """A pool drawn from ``values`` with a normal row every 7th, exact
    ties, and ``frac`` of the rows valid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.tensor(values, dtype=torch.float32, device=dev)
    objs = vals[torch.randint(len(values), (n, k), generator=gen,
                              device=dev)]
    objs[::7] = torch.randn(objs[::7].shape, generator=gen, device=dev)
    dup = min(16, n // 4)
    objs[n // 2:n // 2 + dup] = objs[:dup]
    return objs, torch.rand(n, generator=gen, device=dev) < frac


NONFINITE = (float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1.0,
             -1.0, 2.0)
# finite values that break a careless subtract: +-0, subnormals, +-FLT_MAX
# (differences overflow), adjacent floats
FINITE_EDGES = (0.0, -0.0, 1e-45, -1e-45, 1.2e-38, 3.4028235e38,
                -3.4028235e38, 1.0, 1.0000001, -1.0, 2.0)


@pytest.mark.parametrize("n,k,frac,values", [
    (768, 4, 0.9, "nonfinite"), (4099, 2, 0.9, "nonfinite"),
    (300, 3, 0.0, "nonfinite"), (130, 1, 0.5, "nonfinite"),
    (768, 4, 0.9, "finite edges"), (2000, 3, 0.8, "finite edges"),
    (1000, 2, 1.0, "finite edges")])
def test_pareto_rank_kernel_matches_plain_on_special_values(cuda, n, k, frac,
                                                            values):
    """NaN and +-inf pools go through the kernel's compare path, finite
    pools of edge values through its difference-bits path: both exact."""
    from repro_torch.kernels.pareto_rank import ops
    from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref
    objs, valid = _special_pool(
        n, k, frac, NONFINITE if values == "nonfinite" else FINITE_EDGES,
        cuda, n + k)
    got = ops.dominance_counts(objs, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, dominance_counts_ref(objs, valid))


def test_pareto_rank_kernel_mixes_its_two_paths(cuda):
    """One +inf row in a large finite pool: the staged tiles and the j
    tiles that hold it take the compare path, the others the
    difference-bits path, and the counts stay exact."""
    from repro_torch.kernels.pareto_rank import ops
    from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref
    gen = torch.Generator(device=cuda).manual_seed(5)
    objs = torch.randn(3000, 4, generator=gen, device=cuda)
    objs[1500, 2] = float("inf")
    objs[2500:2504] = objs[:4]
    valid = torch.rand(3000, generator=gen, device=cuda) < 0.9
    got = ops.dominance_counts(objs, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, dominance_counts_ref(objs, valid))


def test_pareto_rank_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.pareto_rank import ops
    objs = torch.zeros(8, 2, device=cuda)
    ok = torch.ones(8, dtype=torch.bool, device=cuda)
    for bad_objs, bad_valid in [(objs.double(), ok), (objs[:, :1].t(), ok),
                                (torch.zeros(8, 5, device=cuda), ok),
                                (objs, ok.float()), (objs, ok.cpu()),
                                (torch.zeros(8, 4, device=cuda)[:, ::2], ok)]:
        with pytest.raises(ValueError):
            ops.dominance_counts(bad_objs, bad_valid)


# lanes: a fused NSGA selection (8 lanes at pop 64) and its telemetry, a
# large k = 4 pool, one lane, and lanes whose pools hold NaN and +-inf
@pytest.mark.parametrize("L,n,k,special", [(8, 128, 2, False),
                                           (8, 64, 2, False),
                                           (3, 768, 4, False),
                                           (1, 128, 2, False),
                                           (5, 200, 3, True)])
def test_pareto_rank_lanes_match_plain_in_one_launch(cuda, L, n, k,
                                                     special):
    from repro_torch.kernels.pareto_rank import ops
    from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref
    gen = torch.Generator(device=cuda).manual_seed(L * n + k)
    objs = torch.randn(L, n, k, generator=gen, device=cuda)
    objs[:, n // 2:n // 2 + 8] = objs[:, :8]
    if special:
        u = torch.rand(L, n, k, generator=gen, device=cuda)
        objs[u < 0.05] = float("nan")
        objs[(u >= 0.05) & (u < 0.1)] = float("inf")
        objs[(u >= 0.1) & (u < 0.15)] = -float("inf")
    valid = torch.rand(L, n, generator=gen, device=cuda) < 0.9
    before = ops.dominance_counts.launches
    got = ops.dominance_counts(objs, valid)
    torch.cuda.synchronize()
    assert ops.dominance_counts.launches - before == 1
    assert torch.equal(got, dominance_counts_ref(objs, valid))
    for i in range(L):
        assert torch.equal(got[i], ops.dominance_counts(objs[i].contiguous(),
                                                        valid[i].contiguous()))
    with pytest.raises(ValueError):
        ops.dominance_counts(objs, valid[:, :-1].contiguous())


def test_fused_lane_equals_its_unbatched_run_on_the_card(cuda):
    from repro_torch.core import presets
    from repro_torch.core.encoding import DesignSpace, random_design
    from repro_torch.core.evaluate import SystemSpec
    from repro_torch.explore.nsga import (NSGAConfig, make_nsga,
                                          make_nsga_fused)
    probs = []
    for name in ("att1", "att2", "att3"):
        spec = SystemSpec.build(presets.bert_mms()[name], ch_max=2)
        probs.append((spec, DesignSpace(spec, max_shape=(16, 16, 4, 4, 1,
                                                         2))))
    spec0, space0 = probs[0]
    cfg = NSGAConfig(pop=64, generations=4)
    pops = [random_design(20 + i, sp, n=64, device=cuda)
            for i, (_, sp) in enumerate(probs)]
    fused = make_nsga_fused(spec0, space0, ("latency_ns", "cost_usd"), cfg,
                            lanes=4, device=cuda)(
        [1, 2, 3, 1], {k: torch.stack([p[k] for p in pops + pops[:1]])
                       for k in pops[0]},
        [p[0].arrays for p in probs + probs[:1]])
    for j, (spec, _) in enumerate(probs):
        single = make_nsga(spec0, space0, ("latency_ns", "cost_usd"), cfg,
                           device=cuda)(j + 1, pops[j], arrays=spec.arrays)
        for k in single[0]:
            assert torch.equal(single[0][k], fused[0][k][j])
        for k in single[3]:
            assert torch.equal(single[3][k], fused[3][k][j])
        np.testing.assert_allclose(fused[4][j].cpu().numpy(),
                                   single[4].cpu().numpy(), rtol=1e-6)


def test_gated_query_runs_on_the_card(cuda, tmp_path):
    """Two neighbors' archives train the gate of a third problem."""
    from repro_torch.api import Problem, Query, Session
    from repro_torch.core import presets
    from repro_torch.explore.service import BudgetPolicy
    s = Session(cache_dir=tmp_path, policy=BudgetPolicy(adaptive=False))

    def prob(name):
        return Problem(presets.bert_mms()[name], ch_max=2,
                       space_kwargs=dict(max_shape=(16, 16, 4, 4, 1, 2)))
    s.submit([Query(prob("att1"), budget=256),
              Query(prob("att3"), budget=256)])
    r = s.submit(Query(prob("att2"), budget=512, engine_opts={
        "surrogate": dict(min_rows=8, epochs=60)}), key=3)
    pv = r.provenance
    assert pv.surrogate_used and pv.n_evals_run + pv.surrogate_hits == 512
    assert len(r.front_objs) and np.all(np.isfinite(r.front_objs))


def test_evaluator_on_card_matches_cpu(cuda):
    from repro_torch.core import presets
    from repro_torch.core.encoding import DesignSpace, random_design
    from repro_torch.core.evaluate import SystemSpec, evaluate_system
    from repro_torch.core.optimizer import metric_stack
    spec = SystemSpec.build(presets.transformer_block(), ch_max=4)
    d = random_design(1, DesignSpace(spec), n=64, device="cpu")
    on_cpu = metric_stack(evaluate_system(spec, d)).numpy()
    on_card = metric_stack(evaluate_system(
        spec, {k: v.to(cuda) for k, v in d.items()})).cpu().numpy()
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4)


def test_short_search_goes_through_the_kernel(cuda, tmp_path):
    from repro_torch.api import Problem, Query, Session
    from repro_torch.core import presets
    from repro_torch.kernels.pareto_rank import ops
    before = ops.dominance_counts.launches
    r = Session(cache_dir=tmp_path).submit(
        Query(Problem(presets.bert_mms()["att2"]), budget=256))
    gens = r.trace.generations
    assert ops.dominance_counts.launches - before >= gens + 1
    assert len(r.front_objs) and np.all(np.isfinite(r.front_objs))


def test_evaluator_on_card_is_deterministic(cuda):
    """The network load and inbound-bandwidth sums add in a fixed order
    on the card (a one-hot GEMM and a reduction, no atomics): one
    population, the same bits on every call."""
    from repro_torch.core import presets
    from repro_torch.core.encoding import DesignSpace, random_design
    from repro_torch.core.evaluate import SystemSpec, make_batch_evaluator
    spec = SystemSpec.build(presets.transformer_block(), ch_max=4)
    d = random_design(7, DesignSpace(spec), n=64, device=cuda)
    ev = make_batch_evaluator(spec, device=cuda)
    first = ev(d)
    for _ in range(10):
        again = ev(d)
        for k in first:
            assert torch.equal(first[k], again[k]), k


def _front_bytes(r):
    return (r.front_objs.tobytes(), r.front_metrics.tobytes(),
            r.trace.archive_hv.tobytes(), r.trace.hypervolume.tobytes())


def test_two_runs_of_one_query_give_identical_fronts(cuda, tmp_path):
    from repro_torch.api import Problem, Query, Session
    from repro_torch.core import presets
    q = Query(Problem(presets.transformer_block(), ch_max=4), budget=512)
    a = Session(cache_dir=tmp_path / "a").submit(q, key=5)
    b = Session(cache_dir=tmp_path / "b").submit(q, key=5)
    assert _front_bytes(a) == _front_bytes(b)


def test_resume_on_the_card_is_bit_identical(cuda, tmp_path):
    from repro_torch.api import Problem, Query, RunControl, Session
    from repro_torch.core import presets
    from repro_torch.explore.service import BudgetPolicy
    q = Query(Problem(presets.transformer_block(), ch_max=4), budget=512,
              policy=BudgetPolicy(chunk_generations=2))
    full = Session(cache_dir=tmp_path / "full").submit(q, key=2)
    ctl = RunControl()
    cut = Session(cache_dir=tmp_path / "cut").submit(
        q, key=2, resume=True, control=ctl,
        on_segment=lambda ev: ev.segment == 1 and ctl.stop())
    assert cut.provenance.interrupted
    rest = Session(cache_dir=tmp_path / "cut").submit(q, key=2, resume=True)
    assert cut.provenance.n_evals_run + rest.provenance.n_evals_run \
        == full.provenance.n_evals_run
    assert _front_bytes(rest) == _front_bytes(full)


def test_submit_async_on_the_card_equals_submit(cuda, tmp_path):
    """A ``submit_async`` job on the card is ``Session.submit`` of the same
    query and seed, bit for bit, while a second job runs in the other
    worker thread."""
    from repro_torch.api import Problem, Query, Session
    from repro_torch.core import presets
    from repro_torch.serve import DONE
    q = Query(Problem(presets.transformer_block(), ch_max=4), budget=512)
    other = Query(Problem(presets.transformer_block(seq=1024), ch_max=4),
                  budget=512)
    sync = Session(cache_dir=tmp_path / "sync").submit(q, key=7)
    s = Session(cache_dir=tmp_path / "async")
    ex = s.executor(max_workers=2)
    h_other = s.submit_async(other, key=1)
    h = s.submit_async(q, key=7)
    r = h.result(timeout=600)
    h_other.result(timeout=600)
    ex.shutdown()
    assert h.state() == DONE and h_other.state() == DONE
    assert _front_bytes(r) == _front_bytes(sync)
    assert r.provenance.n_evals_run == sync.provenance.n_evals_run


def test_two_threads_first_use_of_pareto_rank(cuda, tmp_path, monkeypatch):
    """Two threads reach ``pareto_rank``'s first use at once: one build,
    one library load, every launch counted, every answer exact."""
    import threading
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.pareto_rank import ops
    from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(ops, "_lib", kbuild.LibraryLoader(
        "pareto_rank", ops._lib._load))
    gen = torch.Generator(device=cuda).manual_seed(3)
    objs = torch.randn(128, 2, generator=gen, device=cuda)
    valid = torch.rand(128, generator=gen, device=cuda) < 0.9
    want = dominance_counts_ref(objs, valid)
    calls, go, bad = 200, threading.Barrier(2), []
    before = ops.dominance_counts.launches

    def body():
        go.wait()
        for _ in range(calls):
            if not torch.equal(ops.dominance_counts(objs, valid), want):
                bad.append(1)
    threads = [threading.Thread(target=body) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not bad and ops._lib.loads == 1
    assert ops.dominance_counts.launches - before == 2 * calls
    assert [p.suffix for p in sorted((tmp_path / "kernels").iterdir())] \
        == [".log", ".so"]


def test_archive_merge_on_the_card_equals_the_cpu_merge(cuda):
    from repro_torch.explore.archive import ParetoArchive
    template = {"d": np.zeros((3,), np.int32)}

    def filled(dev, seed):
        r = np.random.default_rng(seed)
        arc = ParetoArchive(32, template, n_obj=2, device=dev)
        arc.insert({"d": r.integers(0, 9, (40, 3))},
                   r.integers(0, 12, (40, 2)).astype(np.float32))
        return arc
    for seed in range(3):
        got = filled(cuda, seed).merge(filled(cuda, seed + 10))
        want = filled("cpu", seed).merge(filled("cpu", seed + 10))
        gd, go = got.front()
        wd, wo = want.front()
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gd["d"], wd["d"])
        assert got.n_evals == want.n_evals == 40


# gp_cov: the reference kernel test's shapes, the BO engine's shapes
# (quickstart d = 62, two_stage d = 60 and 2), a ragged tile edge, d = 1,
# the kernel's edges (m = 64 the last thin tile, m = 65 the first wide
# one, 129 across a 128 x 128 tile, m = 132 its 16-byte stores) and a
# large matrix
GP_SHAPES = [(16, 16, 4), (32, 24, 7), (64, 64, 12), (11, 11, 62),
             (512, 11, 62), (9, 9, 60), (512, 9, 60), (5, 5, 2),
             (512, 5, 2), (190, 130, 7), (64, 48, 1), (100, 64, 62),
             (513, 65, 62), (130, 129, 33), (256, 132, 62),
             (4096, 4096, 62)]


@pytest.mark.parametrize("n,m,d", GP_SHAPES)
def test_gp_cov_kernel_matches_plain(cuda, n, m, d):
    from repro_torch.kernels.gp_cov import ops
    from repro_torch.kernels.gp_cov.ref import matern52_ref
    gen = torch.Generator(device=cuda).manual_seed(n + m + d)
    x1 = torch.rand(n, d, generator=gen, device=cuda)
    x2 = torch.rand(m, d, generator=gen, device=cuda)
    x2[: min(4, m)] = x1[: min(4, m)]                 # coincident points
    for ls in (0.1, 0.3, 0.5, 2.0):
        before = ops.matern52.launches
        got = ops.matern52(x1, x2, ls)
        torch.cuda.synchronize()
        assert ops.matern52.launches == before + 1
        want = matern52_ref(x1, x2, ls)
        assert float((got - want).abs().max()) <= 1e-5
    assert ops._lib.loads == 1                    # one library, any ls


def test_gp_cov_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.gp_cov import ops
    x = torch.zeros(8, 4, device=cuda)
    for a, b in [(x.double(), x), (x, x.half()), (x, torch.zeros(8, 5,
                                                                  device=cuda)),
                 (x.t(), x.t()), (x[:, ::2], x[:, ::2]), (x, x.cpu()),
                 (x.cpu(), x), (x[0], x)]:
        with pytest.raises(ValueError):
            ops.matern52(a, b, 0.3)


def test_bo_sa_query_goes_through_gp_cov(cuda, tmp_path):
    from repro_torch.api import Problem, Query, Session
    from repro_torch.core import presets
    from repro_torch.core.optimizer import OBJ_EDP, SAConfig
    from repro_torch.kernels.gp_cov import ops
    n_iter = 3
    before = ops.matern52.launches
    r = Session(cache_dir=tmp_path).submit(Query(
        Problem(presets.bert_mms()["att2"], ch_max=36), engine="bo_sa",
        weights=OBJ_EDP, engine_opts=dict(n_init=2, n_iter=n_iter,
                                          sa=SAConfig(steps=5, chains=4))))
    assert ops.matern52.launches - before == 2 * n_iter
    assert r.provenance.n_evals_run == (2 + n_iter) * 5 * 4
    assert np.isfinite(r.best_objective)


def test_sa_step_makes_no_host_sync(cuda):
    """``make_sa``'s own step loop — ``mutate``, the evaluation, the
    objective, the accept rule, the temperature read and the best
    tracking — runs under CUDA sync debug mode "error": none of it waits
    for the device.  Only the run's final read of its best is left out."""
    from repro_torch.core import presets
    from repro_torch.core.encoding import DesignSpace, random_design
    from repro_torch.core.evaluate import SystemSpec
    from repro_torch.core.optimizer import OBJ_EDP, SAConfig, make_sa
    spec = SystemSpec.build(presets.transformer_block(), ch_max=6)
    space = DesignSpace(spec, max_total_pes=4096)
    run = make_sa(spec, space, sa=SAConfig(steps=5, chains=4), device=cuda)
    st = run.start(0, random_design(0, space, device=cuda), OBJ_EDP)
    run.steps(st, 0, 1)                   # warm-up: lazy inits may sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.steps(st, 1, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(st["o_best"]).all()
    assert bool((st["o_best"] <= st["o_cur"]).all())


# flash_attention: the reference kernel test's FA_SHAPES, the Hymba prefill
# shape (window 1024 over 1152 positions, GQA 5:1), a ragged Sq = Sk = 1000,
# a kv_valid_len that is not a multiple of the kernel's tiles, two shapes
# with Dv != D, head dims of 128 (the tensor-core kernel's second class),
# and MLA's head dims, D 192 over Dv 128 (causal, with a kv_valid_len, and
# at DeepSeek-V2's width: 128 heads); then decode steps that split the keys
# over blocks (float32: one query over GQA 16 / 8 and 1057 keys with a
# kv_valid_len, MLA's head dims at 4 heads, a key count that leaves a
# ragged last split, 3 queries of 2 heads) and head dims that are not
# multiples of 8 (float32 only: bfloat16 takes multiples of 8)
FA_SHAPES = [
    # (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid)
    (1, 32, 32, 4, 4, 16, 16, "causal", 0, None),
    (2, 64, 64, 8, 2, 32, 32, "causal", 0, None),
    (1, 64, 64, 4, 1, 64, 64, "window", 16, None),
    (2, 32, 32, 4, 2, 16, 16, "none", 0, None),
    (2, 8, 64, 4, 2, 16, 16, "causal", 0, 40),
    (1, 16, 48, 2, 2, 8, 8, "none", 0, 33),
    (4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None),
    (1, 1000, 1000, 4, 2, 64, 64, "window", 300, None),
    (2, 200, 333, 4, 2, 64, 64, "causal", 0, 317),
    (1, 256, 256, 4, 2, 64, 32, "causal", 0, None),
    (2, 96, 160, 4, 1, 16, 64, "window", 48, 150),
    (1, 200, 200, 4, 2, 128, 128, "causal", 0, None),
    (1, 130, 190, 2, 1, 64, 128, "none", 0, None),
    (1, 64, 64, 4, 4, 192, 128, "causal", 0, None),
    (1, 64, 128, 4, 4, 192, 128, "causal", 0, 100),
    (1, 512, 512, 128, 128, 192, 128, "causal", 0, None),
    (4, 1, 1057, 16, 8, 128, 128, "causal", 0, 1025),
    (4, 1, 1057, 4, 4, 192, 128, "causal", 0, 1025),
    (2, 1, 700, 16, 8, 128, 128, "causal", 0, 650),
    (1, 3, 300, 4, 2, 64, 64, "causal", 0, 290),
    (2, 77, 90, 4, 2, 36, 20, "causal", 0, None),
    (2, 1, 333, 8, 1, 37, 53, "window", 100, 300),
]


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, Sq, Sk, H, KV, D, Dv, mk, w, kvl = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + H)
    q = torch.randn(B, Sq, H, D, generator=gen, device=cuda).to(dt)
    k = torch.randn(B, Sk, KV, D, generator=gen, device=cuda).to(dt)
    v = torch.randn(B, Sk, KV, Dv, generator=gen, device=cuda).to(dt)
    if dt == torch.bfloat16 and (D % 8 or Dv % 8):
        # the bf16 kernel takes head dims that are multiples of 8 only
        with pytest.raises(ValueError, match="multiples of 8"):
            ops.flash_attention(q, k, v, mk, w, kvl)
        return
    before = ops.flash_attention.launches
    before_tc = ops.flash_attention.launches_tc
    got = ops.flash_attention(q, k, v, mk, w, kvl)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    # both dtypes run on tensor cores (float32 as 3xTF32)
    assert ops.flash_attention.launches_tc == before_tc + 1
    assert got.dtype == dt and got.shape == (B, Sq, H, Dv)
    want = attention_ref(q, k, v, mk, w, kvl)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [64, 128, 192])
def test_tf32_probe_holds_float32_accuracy_where_one_tf32_product_does_not(
        cuda, D):
    """The float32 kernels' products on wgmma (3xTF32) against float64: a
    64 x 64 x D product within 2^-19 of its terms' magnitudes, where one
    TF32 product of the high parts is off by far more."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device=cuda).manual_seed(D)
    a = torch.randn(64, D, generator=gen, device=cuda)
    b = torch.randn(64, D, generator=gen, device=cuda)
    want = a.double() @ b.double().T
    mag = a.double().abs() @ b.double().abs().T
    err = {n: float(((ops.tf32_probe(a, b, n).double() - want).abs()
                     / mag).max()) for n in (3, 1)}
    assert err[3] <= 2.0 ** -19
    assert err[1] > 64 * err[3]


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import ops
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    bad = [(q.cpu(), k, k), (q, k.cpu(), k), (q.double(), k.double(),
                                               k.double()),
           (q.half(), k.half(), k.half()), (q, k.bfloat16(), k),
           (q.transpose(1, 2), k, k),
           (torch.zeros(1, 16, 4, 16, device=cuda)[:, ::2], k, k),
           (torch.zeros(1, 8, 3, 16, device=cuda), k, k),
           (torch.zeros(1, 8, 4, 256, device=cuda),
            torch.zeros(1, 8, 2, 256, device=cuda),
            torch.zeros(1, 8, 2, 256, device=cuda)),
           # v past the kernels' 128 value dims
           (torch.zeros(1, 8, 4, 128, device=cuda),
            torch.zeros(1, 8, 2, 128, device=cuda),
            torch.zeros(1, 8, 2, 192, device=cuda)),
           # bf16 head dims the tensor-core kernel does not take
           (torch.zeros(1, 8, 4, 12, device=cuda).bfloat16(),
            torch.zeros(1, 8, 2, 12, device=cuda).bfloat16(),
            torch.zeros(1, 8, 2, 12, device=cuda).bfloat16()),
           (q.bfloat16(), k.bfloat16(),
            torch.zeros(1, 8, 2, 20, device=cuda).bfloat16()),
           # bf16 not on a 16-byte boundary
           (torch.zeros(4 * 8 * 16 + 1, device=cuda).bfloat16()[1:].view(
               1, 8, 4, 16), k.bfloat16(), k.bfloat16())]
    for a, b, c in bad:
        with pytest.raises(ValueError):
            ops.flash_attention(a, b, c, "causal")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, "sliding")


# mamba_scan: the reference kernel test's MS_SHAPES (B, S, Di, Ds), the
# Hymba prefill shape and its decode step, and ragged shapes that cross the
# kernel's block of 32 / G channels and its 32-step tile (Ds 1 and 3:
# 4-byte copies and padded states; Ds 32: four threads a channel)
MS_SHAPES = [(1, 16, 8, 4), (2, 32, 16, 8), (1, 64, 32, 16),
             (4, 1152, 3200, 16), (4, 1, 3200, 16), (3, 77, 130, 32),
             (1, 5, 33, 16), (2, 37, 70, 3), (1, 40, 64, 1)]
MS_PREFILL = (4, 1152, 3200, 16)


def _scan_inputs(B, S, Di, Ds, dev, seed, hymba_a=False):
    """Seeded inputs; ``hymba_a`` gives Hymba's own A = -(1..Ds) for every
    channel (``Mamba.reset``) in place of a random one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    u, dl = r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di))
    A = -torch.exp(r(Di, Ds) * 0.3)
    if hymba_a:
        A = -torch.arange(1, Ds + 1, dtype=torch.float32,
                          device=dev).expand(Di, Ds).contiguous()
    return u, dl, A, r(B, S, Ds), r(B, S, Ds), r(B, Di, Ds)


@pytest.mark.parametrize("B,S,Di,Ds", MS_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_kernel_matches_plain(cuda, B, S, Di, Ds, with_h0):
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    u, dl, A, Bc, Cc, h0 = _scan_inputs(B, S, Di, Ds, cuda, S + Di)
    h0 = h0 if with_h0 else None
    before = ops.selective_scan.launches
    y, hT = ops.selective_scan(u, dl, A, Bc, Cc, h0)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    yr, hr = selective_scan_ref(u, dl, A, Bc, Cc, h0)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hT, hr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_kernel_matches_plain_with_hymba_A(cuda, with_h0):
    """The prefill shape with Hymba's A = -(1..16): decays down to
    exp(-16 delta), through the kernel's ex2.approx."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    u, dl, A, Bc, Cc, h0 = _scan_inputs(*MS_PREFILL, cuda, 11, hymba_a=True)
    h0 = h0 if with_h0 else None
    y, hT = ops.selective_scan(u, dl, A, Bc, Cc, h0)
    torch.cuda.synchronize()
    yr, hr = selective_scan_ref(u, dl, A, Bc, Cc, h0)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hT, hr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,Di,Ds", [MS_PREFILL, (4, 1, 3200, 16),
                                       (2, 37, 70, 3)])
def test_mamba_scan_kernel_is_deterministic(cuda, B, S, Di, Ds):
    """Two calls on the same inputs give bitwise-equal y and h_T (no
    atomics, a fixed order of every sum)."""
    from repro_torch.kernels.mamba_scan import ops
    u, dl, A, Bc, Cc, h0 = _scan_inputs(B, S, Di, Ds, cuda, 12)
    y1, h1 = ops.selective_scan(u, dl, A, Bc, Cc, h0)
    y2, h2 = ops.selective_scan(u, dl, A, Bc, Cc, h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_mamba_scan_split_reports_the_launch(cuda):
    """At the Hymba shapes: two threads a channel of 8 states each, one-warp
    blocks of 16 channels, so 800 blocks for 4 x 3200 channels."""
    from repro_torch.kernels.mamba_scan import ops
    got = ops.split(4, 3200, 16)
    assert {k: got[k] for k in ("threads_per_channel", "states_per_thread",
                                "threads_per_block", "blocks")} == dict(
        threads_per_channel=2, states_per_thread=8, threads_per_block=32,
        blocks=800)
    assert got["blocks_per_sm_max_resident"] >= 7
    assert ops.split(1, 33, 3)["threads_per_channel"] == 1


def test_mamba_scan_kernel_threads_its_state(cuda):
    """Scanning [0:S] equals scanning [0:S/2] then [S/2:S] from the carried
    state — the decode-step invariant."""
    from repro_torch.kernels.mamba_scan import ops
    u, dl, A, Bc, Cc, _ = _scan_inputs(2, 96, 200, 16, cuda, 7)
    y, h = ops.selective_scan(u, dl, A, Bc, Cc)
    s = 48
    y1, h1 = ops.selective_scan(*(t[:, :s].contiguous() for t in (u, dl)), A,
                                *(t[:, :s].contiguous() for t in (Bc, Cc)))
    y2, h2 = ops.selective_scan(*(t[:, s:].contiguous() for t in (u, dl)), A,
                                *(t[:, s:].contiguous() for t in (Bc, Cc)),
                                h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(h2, h, atol=1e-4, rtol=1e-4)


def test_mamba_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.mamba_scan import ops
    u, dl, A, Bc, Cc, h0 = _scan_inputs(2, 8, 16, 4, cuda, 0)
    bad = [dict(u=u.cpu()), dict(u=u.double()), dict(u=u.bfloat16()),
           dict(delta=dl.transpose(0, 1).contiguous().transpose(0, 1)),
           dict(A=torch.zeros(16, 40, device=cuda)), dict(h0=h0[..., :2]),
           dict(Bc=Bc[:, :4])]
    for over in bad:
        args = dict(u=u, delta=dl, A=A, Bc=Bc, Cc=Cc, h0=h0) | over
        with pytest.raises(ValueError):
            ops.selective_scan(**args)


def test_reduced_hymba_generate_goes_through_the_kernels(cuda):
    """A reduced-config ``generate`` on the card: one flash-attention launch
    per layer in prefill, one scan launch per layer in prefill and in
    every decode step; in float32 its greedy tokens equal the CPU's."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_reduced("hymba-1.5b"), dtype="float32")
    n_new = 6
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    on_card = build_model(cfg, device=cuda)
    params = on_card.init(0)
    fa.flash_attention.launches = ms.selective_scan.launches = 0
    fa.flash_attention.launches_tc = 0
    r = generate(on_card, params, prompt, n_new)
    assert fa.flash_attention.launches == cfg.n_layers
    # float32 runs on tensor cores too (3xTF32)
    assert fa.flash_attention.launches_tc == cfg.n_layers
    assert ms.selective_scan.launches == cfg.n_layers * n_new
    on_cpu = build_model(cfg, device="cpu")
    r_cpu = generate(on_cpu, params.to("cpu"), prompt, n_new)
    assert torch.equal(r.tokens.cpu(), r_cpu.tokens)
    assert bool(torch.isfinite(r.logits).all())


def test_reduced_hymba_bf16_prefill_runs_on_the_tensor_core_kernel(cuda):
    """The configured dtype (bfloat16): every prefill attention launch is a
    tensor-core launch, and two runs give the same tokens."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    cfg = get_reduced("hymba-1.5b")
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(2))
    model = build_model(cfg, device=cuda)
    params = model.init(0)
    fa.flash_attention.launches = fa.flash_attention.launches_tc = 0
    r = generate(model, params, prompt, 4)
    assert fa.flash_attention.launches == cfg.n_layers
    assert fa.flash_attention.launches_tc == cfg.n_layers
    assert bool(torch.isfinite(r.logits).all())
    assert torch.equal(r.tokens, generate(model, params, prompt, 4).tokens)


def _family_run(arch, dev, dtype=None, n_new=5, batch=2, prompt=40):
    """A reduced-config ``generate`` of ``arch`` on ``dev`` with the
    family's stub inputs, weights from seed 0."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import generate, stub_inputs
    from repro_torch.models.model import build_model
    cfg = get_reduced(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen)
    inputs = stub_inputs(cfg, batch, prompt, gen)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    return cfg, lambda p=params, m=model: generate(m, p, tokens, n_new,
                                                   **inputs), params


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b",
                                  "whisper-tiny"])
def test_reduced_family_generate_goes_through_the_kernels(cuda, arch):
    """The configured dtype (bfloat16): one tensor-core attention launch a
    layer in prefill and in every decode step (over the full KV cache, or
    MLA's latent; whisper's decoder two, self and cross, and its encoder
    one a layer in prefill), and two runs give the same tokens."""
    from repro_torch.kernels.flash_attention import ops as fa
    n_new = 5
    cfg, run, _ = _family_run(arch, cuda, n_new=n_new)
    per_step = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
    fa.flash_attention.launches = fa.flash_attention.launches_tc = 0
    r = run()
    want = cfg.enc_layers + per_step * n_new
    assert fa.flash_attention.launches == want
    assert fa.flash_attention.launches_tc == want
    assert bool(torch.isfinite(r.logits).all())
    assert torch.equal(r.tokens, run().tokens)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b",
                                  "qwen2-vl-72b", "deepseek-v2-236b",
                                  "grok-1-314b", "whisper-tiny"])
def test_reduced_family_float32_generate_equals_the_cpus(cuda, arch):
    """Float32 on the card (the 3xTF32 attention kernels, the scan) and on the
    CPU (plain versions), one weight set: the same greedy tokens, logits
    within 1e-3."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    cfg, run, params = _family_run(arch, cuda, dtype="float32")
    fa.flash_attention.launches = ms.selective_scan.launches = 0
    fa.flash_attention.launches_tc = 0
    r = run()
    if cfg.family == "ssm":
        assert ms.selective_scan.launches == cfg.n_layers * 5
        assert fa.flash_attention.launches == 0
    else:
        assert fa.flash_attention.launches > 0
        assert fa.flash_attention.launches_tc == fa.flash_attention.launches
    _, run_cpu, _ = _family_run(arch, "cpu", dtype="float32")
    r_cpu = run_cpu(p=params.to("cpu"))
    assert torch.equal(r.tokens.cpu(), r_cpu.tokens)
    assert float((r.logits.cpu() - r_cpu.logits).abs().max()) <= 1e-3


def test_calibration_fit_on_the_card_matches_the_cpu(cuda):
    """The default calibration (the simulator sweep plus the published
    baseline rows under ``DEFAULT_FREE``) fit on the card: its constants
    within rtol 1e-3 of the CPU fit's, and two card fits give one
    artifact digest (a repeatable backward)."""
    from repro_torch.calib import baseline_measurements, fit, simulator_sweep
    ms = simulator_sweep() + baseline_measurements()
    cpu = fit(ms, steps=100, device="cpu")
    a = fit(ms, steps=100, device="cuda")
    b = fit(ms, steps=100, device="cuda")
    assert a.digest == b.digest
    for f, v in cpu.fitted.items():
        assert a.fitted[f] == pytest.approx(v, rel=1e-3), f


# ---------------------------------------------------------------------------
# training: the two backward kernels and a train step on the card
# ---------------------------------------------------------------------------
# (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid_len): chip_smoke's phase
# 17 (a) shapes
FA_BWD_SHAPES = [(4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None),
                 (1, 1024, 1024, 16, 8, 128, 128, "causal", 0, None),
                 (1, 512, 512, 16, 16, 192, 128, "causal", 0, None),
                 (1, 1500, 1500, 6, 6, 64, 64, "none", 0, None),
                 (2, 200, 333, 25, 5, 64, 64, "causal", 0, 317),
                 (1, 40, 48, 4, 2, 16, 16, "causal", 0, None),
                 (2, 96, 160, 4, 1, 16, 64, "window", 48, 150)]


def _sdpa_grads(q, k, v, dout, mask, w, kvl):
    """(dq, dk, dv) of one ``scaled_dot_product_attention`` call (the
    yardstick; the port never calls it) with the port's mask as a boolean
    mask, in the port's (B, S, H, D) layout."""
    Sq, Sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    valid = Sk if kvl is None else kvl
    qp = torch.arange(Sq, device=q.device)[:, None] + (
        valid - Sq if kvl is not None else 0)
    kp = torch.arange(Sk, device=q.device)[None, :]
    allowed = kp < valid
    if mask != "none":
        allowed = allowed & (kp <= qp)
    if mask == "window":
        allowed = allowed & (qp - kp < w)
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allowed, enable_gqa=True)
    gs = torch.autograd.grad(o, (qt, kt, vt),
                             dout.transpose(1, 2).contiguous())
    return tuple(g.transpose(1, 2) for g in gs)


@pytest.mark.parametrize("shape", FA_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The backward kernels against their plain versions on the same
    residuals: float32 (the 3xTF32 tensor-core kernels) against the plain
    backward at the reference's 3e-5; bfloat16 (the tensor-core kernels)
    against their
    mirror ``flash_attention_bwd_tc_mirror`` within ``tc_bwd_agreement``'s
    gate (two bf16 roundings plus 1e-4 of the largest gradient; at most 64
    elements a tensor past that, each within 2^-7 of the tensor's largest
    magnitude, where P or dS rounded to the neighbouring bf16 value), and
    against the float32 plain backward within twice the error of
    ``scaled_dot_product_attention``'s backward on the same inputs.  Two
    calls bitwise equal, each adding its three kernel launches to
    ``launches_bwd``."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_blocked, flash_attention_bwd_tc_mirror,
        tc_bwd_agreement)
    B, Sq, Sk, H, KV, D, Dv, mask, w, kvl = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dt)
    q, k, v, do = r(B, Sq, H, D), r(B, Sk, KV, D), r(B, Sk, KV, Dv), \
        r(B, Sq, H, Dv)
    out, lse = ops.flash_attention_fwd_lse(q, k, v, mask, w, kvl)
    before = ops.flash_attention.launches_bwd
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, mask, w, kvl)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, mask, w, kvl)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_bwd == before + 2 * ops.BWD_LAUNCHES
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
    if dt == torch.float32:
        want = flash_attention_bwd_blocked(q, k, v, out, lse, do, mask, w,
                                           kvl)
        for a, b in zip(got, want):
            assert bool(((a - b).abs() <= 3e-5 + 3e-5 * b.abs()).all())
        return
    want = flash_attention_bwd_tc_mirror(q, k, v, out, lse, do, mask, w, kvl)
    f32 = flash_attention_bwd_blocked(q.float(), k.float(), v.float(),
                                      out.float(), lse, do.float(), mask, w,
                                      kvl)
    lib = _sdpa_grads(q, k, v, do, mask, w, kvl)
    for name, a, b, f, s in zip(("dq", "dk", "dv"), got, want, f32, lib):
        agreement = tc_bwd_agreement(a, b)
        assert agreement["ok"], (name, agreement)
        ours = float((a.float() - f).abs().max())
        theirs = float((s.float() - f).abs().max())
        assert ours <= 2.0 * theirs, (name, ours, theirs)


@pytest.mark.parametrize("B,S,Di,Ds,with_h0", [
    (4, 1152, 3200, 16, False), (1, 512, 8192, 16, True),
    (2, 37, 70, 3, True), (3, 77, 130, 32, True), (1, 1, 64, 1, True)])
def test_mamba_scan_bwd_kernel_matches_plain(cuda, B, S, Di, Ds, with_h0):
    """The scan backward against the plain reverse-time version within
    1e-4, two calls bitwise equal, each adding its kernel launches (the
    reverse scan and the sums of its partials) to ``launches_bwd``."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref
    gen = torch.Generator(device=cuda).manual_seed(S + Di)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = (r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di)),
            -torch.exp(r(Di, Ds) * 0.3), r(B, S, Ds), r(B, S, Ds),
            r(B, Di, Ds) if with_h0 else None, r(B, S, Di),
            r(B, Di, Ds) if with_h0 else None)
    before = ops.selective_scan.launches_bwd
    got = ops.selective_scan_bwd(*args)
    again = ops.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches_bwd == before + 2 * ops.BWD_LAUNCHES
    for a, a2, b in zip(got, again, selective_scan_bwd_ref(*args)):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, a2)
        assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())


@pytest.mark.parametrize("B,S,Di,Ds,with_h0", [
    (4, 1152, 3200, 16, False), (2, 37, 70, 3, True), (1, 5, 33, 16, True)])
def test_mamba_scan_chunk_states_and_backward_from_them(cuda, B, S, Di, Ds,
                                                         with_h0):
    """The forward's chunk states (what ``SelectiveScanFn`` saves) against
    the plain forward's within 1e-4, its y and h_T bit for bit those of the
    forward without states (serving unchanged), and the backward from them
    bit for bit the backward that runs the forward itself."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    gen = torch.Generator(device=cuda).manual_seed(S + Ds)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    u, dl = r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di))
    A, Bc, Cc = -torch.exp(r(Di, Ds) * 0.3), r(B, S, Ds), r(B, S, Ds)
    h0 = r(B, Di, Ds) if with_h0 else None
    y, hT, states = ops.selective_scan_fwd_states(u, dl, A, Bc, Cc, h0)
    y0, hT0 = ops.selective_scan(u, dl, A, Bc, Cc, h0)
    assert torch.equal(y, y0) and torch.equal(hT, hT0)
    want = selective_scan_ref(u, dl, A, Bc, Cc, h0, return_states=True)[2]
    assert states.shape == (B, -(-S // ops.STATE_CHUNK), Di, Ds)
    assert bool(((states - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    dy = r(B, S, Di)
    a = ops.selective_scan_bwd(u, dl, A, Bc, Cc, h0, dy, None, states)
    b = ops.selective_scan_bwd(u, dl, A, Bc, Cc, h0, dy)
    assert all(x is None or torch.equal(x, z) for x, z in zip(a, b))


def test_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """A CUDA call the backward kernels do not take raises; nothing falls
    back to the plain versions."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    q = torch.randn(1, 8, 2, 16, device=cuda)
    out, lse = fa.flash_attention_fwd_lse(q, q, q)
    before = fa.flash_attention.launches_bwd
    with pytest.raises(ValueError):          # a head dim past 192
        big = torch.randn(1, 8, 2, 200, device=cuda)
        fa.flash_attention_bwd(big, big, big[..., :16].contiguous(), out,
                               lse, out)
    with pytest.raises(ValueError):          # float16
        h = q.half()
        fa.flash_attention_bwd(h, h, h, out.half(), lse, out.half())
    with pytest.raises(ValueError):          # lse on the CPU
        fa.flash_attention_bwd(q, q, q, out, lse.cpu(), out)
    assert fa.flash_attention.launches_bwd == before
    u = torch.randn(1, 4, 8, device=cuda)
    A = -torch.ones(8, 40, device=cuda)      # state size past 32
    Bc = torch.randn(1, 4, 40, device=cuda)
    with pytest.raises(ValueError):
        ms.selective_scan_bwd(u, u, A, Bc, Bc, None, u)


def test_reduced_hymba_train_step_runs_every_kernel(cuda):
    """A reduced Hymba train step on the card (bf16, remat ``dots``): every
    attention and scan, forward (and its recomputation) and backward, on the
    kernels; the loss finite, the parameters moved."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_reduced("hymba-1.5b")
    model = build_model(cfg, cuda)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    st = make_train_state(model, 0, opt)
    before = [p.detach().clone() for p in st["params"].parameters()]
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=2)).batch_at(0)
    fa.flash_attention.launches = fa.flash_attention.launches_tc = 0
    fa.flash_attention.launches_bwd = 0
    ms.selective_scan.launches = ms.selective_scan.launches_bwd = 0
    st, m = make_train_step(model, opt)(st, batch)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (fa.flash_attention.launches, fa.flash_attention.launches_tc,
            fa.flash_attention.launches_bwd) == (2 * L, 2 * L,
                                                 fa.BWD_LAUNCHES * L)
    assert (ms.selective_scan.launches,
            ms.selective_scan.launches_bwd) == (2 * L, ms.BWD_LAUNCHES * L)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, st["params"].parameters()))
