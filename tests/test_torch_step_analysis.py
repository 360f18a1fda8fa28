"""The port's step analysis (``launch.graph_analysis``) on the CPU, the cases
of the reference's ``tests/test_launch_analysis.py`` and the kernels as
operators:

* a loop of 10 ``tanh(x @ w)`` on 256 x 256 counts 2 * 256^3 * 10 FLOPs,
  4 x 5 nested loops on 128 x 128 count 2 * 128^3 * 20 (eager tracing
  unrolls every loop), and a loop-free ``(a @ b) @ b`` equals
  ``torch.utils.flop_counter.FlopCounterMode`` (all exact);
* the collectives' wire bytes equal the reference's ``collective_stats``
  at group size 4 (rtol 1e-12), traced under the ``fake`` process group;
* ``roofline`` equals the reference's at rtol 1e-12 given the reference
  target's numbers (read from ``repro.core.constants.DEFAULT_TPU``);
* every kernel operator passes ``torch.library.opcheck`` on the CPU, and
  the analysis counts each exactly once a call, by its ``cost.py``
  formula, with no operator of its plain version;
* the live-bytes peak, and a train step of the reduced Hymba traced with
  nothing launched: each layer's attention and scan forward twice (remat)
  and backward once, as the card runs it.
"""

import jax  # noqa: F401  (the reference's modules import it)
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.constants import DEFAULT_TPU
from repro.launch import hlo_analysis as H

from repro_torch.configs import get_reduced
from repro_torch.core.constants import DEFAULT_H100, H100Target
from repro_torch.kernels.flash_attention import cost as fa_cost
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gp_cov import cost as gp_cost
from repro_torch.kernels.gp_cov import ops as gp_ops
from repro_torch.kernels.mamba_scan import cost as ms_cost
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.pareto_rank import cost as pareto_cost
from repro_torch.kernels.pareto_rank import ops as pareto_ops
from repro_torch.launch import graph_analysis as G
from repro_torch.launch.specs import batch_specs, sds
from repro_torch.launch.train import make_train_step, train_state_specs
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig

RTOL = 1e-12
F32 = torch.float32


def test_counts_loop_trips():
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x
    x = sds((256, 256), F32)
    an = G.analyze(f, x, x, device="cpu")
    assert an.flops == 2 * 256 ** 3 * 10
    assert an.result.shape == (256, 256)


def test_counts_nested_loop_trips():
    def g(x, w):
        for _ in range(4):
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x
    x = sds((128, 128), F32)
    assert G.analyze(g, x, x, device="cpu").flops == 2 * 128 ** 3 * 20


def test_loop_free_equals_flop_counter():
    def f(a, b):
        return (a @ b) @ b
    x = sds((128, 128), F32)
    an = G.analyze(f, x, x, device="cpu")
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        t = torch.randn(128, 128)
        f(t, t)
    assert an.flops == fc.get_total_flops()
    # two products: each reads two 64 KiB operands and writes one
    assert an.bytes_all == an.bytes_heavy == 2 * 3 * 128 * 128 * 4
    assert an.kernels == {} and an.ops == 2


def test_fake_cuda_forward_needs_no_card():
    """A forward traces on fake CUDA tensors on any build."""
    before = fa_ops.flash_attention.launches
    q = sds((1, 64, 4, 64), torch.bfloat16)
    an = G.analyze(lambda q, k, v: fa_ops.flash_attention(q, k, v), q, q, q,
                   device="cuda")
    assert an.result.device.type == "cuda"
    assert an.kernels["repro_torch::flash_attention"]["calls"] == 1
    assert fa_ops.flash_attention.launches == before


def test_peak_counts_live_storages():
    n = 1024 * 256

    def f(x):
        return (x * 2) * 3                  # x, x * 2 and the result live
    an = G.analyze(f, sds((n,), F32), device="cpu")
    assert an.input_bytes == 4 * n
    assert an.peak_bytes == 3 * 4 * n


def _hlo(lines):
    body = "\n".join(f"  %c{i} = {ln}, replica_groups={{{{0,1,2,3}}}}"
                     for i, ln in enumerate(lines))
    return f"ENTRY %main (x: f32[1024]) -> f32[1024] {{\n{body}\n}}\n"


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_collective_wire_factors_match_reference(fake_group):
    import torch.distributed._functional_collectives as fc

    def step(x):
        a = fc.all_reduce(x, "sum", fake_group)
        b = fc.all_gather_tensor(x, 0, fake_group)
        c = fc.reduce_scatter_tensor(x, "sum", 0, fake_group)
        d = fc.all_to_all_single(x, None, None, fake_group)
        return a, b, c, d
    an = G.analyze(step, sds((1024,), F32), device="cpu")
    want = H.collective_stats(_hlo([
        "f32[1024]{0} all-reduce(%x)", "f32[4096]{0} all-gather(%x)",
        "f32[256]{0} reduce-scatter(%x)", "f32[1024]{0} all-to-all(%x)"]))
    for kind in G.COLLECTIVES:
        assert an.collectives[kind] == want["counts"][kind] == 1
        np.testing.assert_allclose(an.wire_bytes[kind],
                                   want["wire_bytes"][kind], rtol=RTOL)
    np.testing.assert_allclose(an.total_wire_bytes,
                               want["total_wire_bytes"], rtol=RTOL)


def _tpu_numbers() -> H100Target:
    t = DEFAULT_TPU
    return H100Target(peak_bf16_tflops=t.peak_bf16_tflops,
                      hbm_gbps=t.hbm_gbps, link_gbps=t.ici_link_gbps,
                      links_per_chip=t.ici_links_per_chip,
                      hbm_bytes=t.hbm_bytes, smem_bytes=t.vmem_bytes)


ROOFLINE_CASES = [
    (197e12, 819e9 / 2, 0.0, 256, 197e12 * 256, 0.0),
    (1e9, 819e9, 0.0, 256, 1e9 * 256, 819e9 * 256),
    (3.2e13, 1.1e12, 4.4e11, 8, 2.0e14, 0.0),
    (0.0, 0.0, 0.0, 1, 0.0, 0.0),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_roofline_matches_reference(case):
    got = G.roofline(*case, target=_tpu_numbers()).to_dict()
    want = H.roofline(*case, tpu=DEFAULT_TPU).to_dict()
    assert got.pop("bottleneck") == want.pop("bottleneck")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_default_target_is_the_h100():
    assert DEFAULT_H100.peak_bf16_tflops == 989.4
    assert DEFAULT_H100.hbm_gbps == 3350.0
    assert DEFAULT_H100.links_per_chip * DEFAULT_H100.link_gbps == 450.0
    r = G.roofline(989.4e12, 0.0, 0.0, 1, 989.4e12)
    assert r.compute_s == pytest.approx(1.0) and r.roofline_frac == \
        pytest.approx(1.0)


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    objs = r(40, 3)
    objs[5] = objs[4]
    valid = torch.rand(40, generator=g) > 0.2
    q, k, v = r(1, 12, 4, 16), r(1, 12, 2, 16), r(1, 12, 2, 8)
    out, lse = fa_ops.flash_attention_fwd_lse(q, k, v, "window", 5, None)
    u, dl = r(2, 20, 6), r(2, 20, 6).abs() * 0.1
    A, Bc, Cc, h0 = -r(6, 3).abs(), r(2, 20, 3), r(2, 20, 3), r(2, 6, 3)
    states = ms_ops.selective_scan_fwd_states(u, dl, A, Bc, Cc, h0)[2]
    masks = ("window", 5, None)
    return [
        ("dominance_counts", pareto_ops.OP, (objs, valid),
         pareto_cost.op_work),
        ("matern52", gp_ops.OP, (r(9, 5), r(7, 5), 0.4), gp_cost.op_work),
        ("flash_attention", fa_ops.FWD, (q, k, v, "causal", 0, 10),
         fa_cost.fwd_op_work),
        ("flash_attention_fwd_lse", fa_ops.FWD_LSE, (q, k, v, *masks),
         fa_cost.fwd_lse_op_work),
        ("flash_attention_bwd", fa_ops.BWD, (q, k, v, out, lse, out, *masks),
         fa_cost.bwd_op_work),
        ("selective_scan", ms_ops.FWD, (u, dl, A, Bc, Cc, None),
         ms_cost.fwd_op_work),
        ("selective_scan_fwd_states", ms_ops.FWD_STATES,
         (u, dl, A, Bc, Cc, h0), ms_cost.fwd_states_op_work),
        ("selective_scan_bwd", ms_ops.BWD,
         (u, dl, A, Bc, Cc, h0, u, h0, states), ms_cost.bwd_op_work),
        ("selective_scan_bwd without states", ms_ops.BWD,
         (u, dl, A, Bc, Cc, None, u, None, None), ms_cost.bwd_op_work),
    ]


CASES = _kernel_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_operator_passes_opcheck(case):
    _, op, args, _ = case
    torch.library.opcheck(op, args)


def _spec_of(a):
    return sds(a.shape, a.dtype) if isinstance(a, torch.Tensor) else a


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_operator_counted_once_by_its_formula(case):
    _, op, args, work = case
    an = G.analyze(lambda *a: op(*a), *map(_spec_of, args), device="cpu")
    want = work(*args)
    assert an.kernels == {op.name(): dict(calls=1, **want)}
    assert an.ops == 1                      # nothing of the plain version
    assert an.flops == an.flops_kernels == want["flops"]
    assert an.bytes_all == an.bytes_heavy == want["bytes"]


def test_formulas_count_what_the_card_launches():
    q = torch.empty(1, 8, 2, 16)
    bwd = fa_cost.bwd_op_work(q, q, q, q, None, q, "causal", 0, None)
    assert bwd["launches"] == fa_ops.BWD_LAUNCHES == 3
    none = torch.empty(1, 0, 2, 16)
    assert fa_cost.bwd_op_work(q, none, none, q, None, q, "none", 0,
                               None)["launches"] == 2
    u, A = torch.empty(1, 40, 4), torch.empty(4, 2)
    assert ms_cost.bwd_op_work(u, u, A, None, None, None, u, None,
                               torch.empty(1, 3, 4, 2))["launches"] == 2
    # causal: row i sees i + 1 keys; window 4 caps it
    assert fa_cost.visible_pairs(8, 8, "causal", 0, None) == 36
    assert fa_cost.visible_pairs(8, 8, "window", 4, None) == 26
    assert fa_cost.visible_pairs(1, 9, "causal", 0, 7) == 7


def test_reduced_hymba_train_step_traced_as_the_card_runs_it():
    cfg = get_reduced("hymba_1_5b")
    model = build_model(cfg, "cpu")
    opt = AdamWConfig()
    batch = batch_specs(cfg, 2, 32, with_labels=True)
    counters = (fa_ops.flash_attention.launches,
                fa_ops.flash_attention.launches_bwd,
                ms_ops.selective_scan.launches,
                ms_ops.selective_scan.launches_bwd)
    an = G.analyze(make_train_step(model, opt),
                   train_state_specs(model, opt), batch, device="cpu")
    L = cfg.n_layers
    k = {n.split("::")[1]: v for n, v in an.kernels.items()}
    assert {n: v["launches"] for n, v in k.items()} == {
        "flash_attention_fwd_lse": 2 * L, "selective_scan_fwd_states": 2 * L,
        "flash_attention_bwd": 3 * L, "selective_scan_bwd": 2 * L}
    assert {n: v["calls"] for n, v in k.items()} == {
        "flash_attention_fwd_lse": 2 * L, "selective_scan_fwd_states": 2 * L,
        "flash_attention_bwd": L, "selective_scan_bwd": L}
    assert counters == (fa_ops.flash_attention.launches,
                        fa_ops.flash_attention.launches_bwd,
                        ms_ops.selective_scan.launches,
                        ms_ops.selective_scan.launches_bwd)
    n_params = sum(p.numel() for p in
                   train_state_specs(model, opt)["params"].parameters())
    # float32 parameters and bf16 moments, at least
    assert an.input_bytes >= n_params * (4 + 2 + 2)
    assert an.peak_bytes > an.input_bytes
    assert an.flops > an.flops_kernels > 0


def test_autograd_on_fake_cuda_needs_a_cuda_build():
    if torch.backends.cuda.is_built():
        pytest.skip("this PyTorch is built with CUDA")
    x = sds((8, 8), F32).requires_grad_(True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.analyze(lambda x: (x * x).sum().backward(), x, device="cuda")

