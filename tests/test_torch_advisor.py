"""The port's autosharding advisor and dry-run model terms against the JAX
reference, on the CPU:

* ``predict`` equals the reference's at rtol 1e-12 over all of
  ``plan_space`` for qwen2-72b, grok-1 and deepseek-v2 at ``train_4k``,
  ``prefill_32k`` and ``decode_32k``, given the reference target's numbers
  (read from ``repro.core.constants.DEFAULT_TPU``), and ``exhaustive_best``
  picks the same plan;
* ``bo_search``: its first 8 draws (numpy's, seeded alike) score the same
  as the reference's, at rtol 1e-12; then the two GPs (float32, different
  libraries) may part, so its best ``step_s`` is held to the reference's
  under a pooled gate fixed before its first reading: over seeds 0-7 of
  qwen2-72b ``train_4k`` at budget 12 (the reference compiles its GP's
  linear algebra anew for every size of the sample, seconds each), the
  mean of log(port best / reference best) at most log(1.05);
* on ``DEFAULT_H100``, grok-1 on 4 cards is infeasible;
* ``launch.dryrun``: ``default_parallel``, ``model_flops_for`` and
  ``model_min_bytes_for`` equal to the reference's over every cell.
"""

import dataclasses
import math

import jax  # noqa: F401  (the reference's modules import it)
import numpy as np
import pytest

from repro.autosharding import advisor as ref_adv
from repro.configs import get_config as ref_get_config
from repro.core.constants import DEFAULT_TPU
from repro.launch import dryrun as ref_dryrun
from repro.launch.specs import input_specs as ref_input_specs
from repro.models.config import SHAPES as REF_SHAPES

from repro_torch.autosharding import advisor as adv
from repro_torch.configs import ARCH_IDS, cells, get_config
from repro_torch.core.constants import DEFAULT_H100, H100Target
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from repro_torch.models.config import SHAPES

RTOL = 1e-12
ARCHS = ("qwen2_72b", "grok_1_314b", "deepseek_v2_236b")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
# the pooled bo_search gate (fixed before its first reading)
BO_CELLS = (("qwen2_72b", "train_4k"),)
BO_SEEDS = tuple(range(8))
BO_BUDGET = 12
BO_LOG_GATE = math.log(1.05)


def _tpu_numbers() -> H100Target:
    t = DEFAULT_TPU
    return H100Target(peak_bf16_tflops=t.peak_bf16_tflops,
                      hbm_gbps=t.hbm_gbps, link_gbps=t.ici_link_gbps,
                      links_per_chip=t.ici_links_per_chip,
                      hbm_bytes=t.hbm_bytes, smem_bytes=t.vmem_bytes)


def _ref_plan(p):
    return ref_adv.ShardPlan(**dataclasses.asdict(p))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", KINDS)
def test_predict_matches_reference_over_the_plan_space(arch, shape):
    cfg, sc = get_config(arch), SHAPES[shape]
    ref_cfg, ref_sc = ref_get_config(arch), REF_SHAPES[shape]
    target = _tpu_numbers()
    plans = adv.plan_space(256, train=(sc.kind == "train"))
    assert [dataclasses.asdict(p) for p in plans] == [
        dataclasses.asdict(p) for p in
        ref_adv.plan_space(256, train=(sc.kind == "train"))]
    for p in plans:
        got = adv.predict(cfg, sc, p, target=target).to_dict()
        want = ref_adv.predict(ref_cfg, ref_sc, _ref_plan(p)).to_dict()
        assert got.pop("feasible") == want.pop("feasible"), p
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       err_msg=f"{p} {k}")
    best, score, scored = adv.exhaustive_best(cfg, sc, 256, target=target)
    ref_best, ref_score, _ = ref_adv.exhaustive_best(ref_cfg, ref_sc, 256)
    assert (best is None) == (ref_best is None)   # none fits 16 GB cards
    if best is not None:
        assert dataclasses.asdict(best) == dataclasses.asdict(ref_best)
        np.testing.assert_allclose(score.step_s, ref_score.step_s,
                                   rtol=RTOL)
    assert adv.advise(cfg, sc, 256, target=target) == \
        ref_adv.advise(ref_cfg, ref_sc, 256)


def test_bo_search_draws_alike_and_holds_the_pooled_gate():
    target = _tpu_numbers()
    logs = []
    for arch, shape in BO_CELLS:
        cfg, sc = get_config(arch), SHAPES[shape]
        ref_cfg, ref_sc = ref_get_config(arch), REF_SHAPES[shape]
        for seed in BO_SEEDS:
            plan, score, n, trace = adv.bo_search(
                cfg, sc, 256, budget=BO_BUDGET, seed=seed, target=target,
                device="cpu")
            r_plan, r_score, r_n, r_trace = ref_adv.bo_search(
                ref_cfg, ref_sc, 256, budget=BO_BUDGET, seed=seed)
            assert n == r_n == BO_BUDGET
            np.testing.assert_allclose([t[1] for t in trace[:8]],
                                       [t[1] for t in r_trace[:8]],
                                       rtol=RTOL)
            # the best score is the best plan's, re-predicted
            assert score.step_s == adv.predict(cfg, sc, plan,
                                               target=target).step_s
            logs.append(math.log(score.step_s / r_score.step_s))
    print(f"bo_search gate: log(port / reference best) {logs}, mean "
          f"{np.mean(logs):.6g} (gate {BO_LOG_GATE:.6g})")
    assert np.mean(logs) <= BO_LOG_GATE, logs


def test_bo_search_refuses_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adv.bo_search(get_config("qwen2_72b"), SHAPES["train_4k"])


def test_grok_on_four_cards_is_infeasible():
    tiny = adv.ShardPlan(data=1, model=4, microbatch=1, remat="none")
    s = adv.predict(get_config("grok_1_314b"), SHAPES["train_4k"], tiny)
    assert not s.feasible                    # 314B on 4 x 80 GB cannot fit
    assert s.hbm_gb > 0.9 * DEFAULT_H100.hbm_bytes / 1e9


def test_h100_best_plan_is_feasible_on_its_card():
    plan, score, scored = adv.exhaustive_best(get_config("qwen2_72b"),
                                              SHAPES["train_4k"], 256)
    assert score.feasible
    assert score.hbm_gb < 0.9 * DEFAULT_H100.hbm_bytes / 1e9
    assert 0 < sum(1 for _, s in scored if s.feasible) < len(scored)


CELLS = [(a, c) for a in ARCH_IDS for c in cells(a)]


@pytest.mark.parametrize("arch,cell", CELLS, ids=[f"{a}-{c}" for a, c in
                                                 CELLS])
def test_dryrun_model_terms_match_reference(arch, cell):
    pc, over = dryrun.default_parallel(arch, cell)
    ref_pc, ref_over = ref_dryrun.default_parallel(arch, cell)
    assert dataclasses.asdict(pc) == dataclasses.asdict(ref_pc)
    assert over == ref_over
    cfg, sc = get_config(arch), SHAPES[cell]
    ref_cfg, ref_sc = ref_get_config(arch), REF_SHAPES[cell]
    assert dryrun.model_flops_for(cfg, sc) == \
        ref_dryrun.model_flops_for(ref_cfg, ref_sc)
    got = dryrun.model_min_bytes_for(cfg, sc, input_specs(arch, cell))
    want = ref_dryrun.model_min_bytes_for(ref_cfg, ref_sc,
                                          ref_input_specs(arch, cell))
    assert got == want
    assert (got > 0) == (sc.kind == "decode")
