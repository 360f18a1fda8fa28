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
