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


@pytest.mark.parametrize("n,k,frac", [(128, 2, 1.0), (768, 4, 1.0),
                                      (190, 3, 0.9), (8192, 4, 0.8),
                                      (256, 4, 0.0), (1, 1, 1.0)])
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


# gp_cov: the reference kernel test's shapes, the BO engine's shapes
# (quickstart d = 62, two_stage d = 60 and 2), a ragged tile edge, d = 1
# and a large matrix
GP_SHAPES = [(16, 16, 4), (32, 24, 7), (64, 64, 12), (11, 11, 62),
             (512, 11, 62), (9, 9, 60), (512, 9, 60), (5, 5, 2),
             (512, 5, 2), (190, 130, 7), (64, 48, 1), (4096, 4096, 62)]


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
    assert ops._lib.cache_info().currsize == 1      # one library, any ls


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
