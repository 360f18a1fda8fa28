"""The port's readable model references on the CPU: the pipeline stage
graph (``core/perf_model.py``), the systolic simulator
(``core/simulator.py``) and the Map / Bind / Reduce formalism
(``core/mapping.py``).

* the simulator, ``perf_model`` and mapping cases of
  ``tests/test_core_models.py`` (the fig. 5 stage graph, the shared chiplet,
  analytical vs. systolic) and ``tests/test_core_workload.py`` on the port;
* parity with the reference: ``simulate_matmul``, ``simulate_pipeline``,
  ``StageGraph.latency`` / ``throughput`` / ``total_time`` and the mapping
  functions give exactly the reference's values on the same inputs, and
  the port's analytical latency (``analyze_chiplet``) agrees with the
  reference's at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import mapping as ref_mapping
from repro.core import perf_model as ref_pm
from repro.core import simulator as ref_sim
from repro.core.dataflow import analyze_chiplet as ref_analyze
from repro.core.workload import matmul as ref_matmul

from repro_torch.core import mapping
from repro_torch.core.dataflow import analyze_chiplet
from repro_torch.core.perf_model import build_stage_graph
from repro_torch.core.simulator import (SystolicConfig, simulate_matmul,
                                        simulate_pipeline)
from repro_torch.core.workload import Edge, WorkloadGraph, matmul

SHAPES = [(64, 64, 64), (128, 128, 128), (128, 512, 256), (256, 256, 256),
          (512, 512, 128), (512, 64, 512), (100, 100, 100), (72, 56, 40),
          (320, 192, 96)]


# ---------------------------------------------------------------------------
# pipeline model (paper Fig. 5a example)
# ---------------------------------------------------------------------------
def test_fig5_stage_graph():
    """v0, v1 in parallel; e01: v0->v2 ; e12: v1->v2."""
    kw = dict(compute_delays={0: 10.0, 1: 8.0, 2: 6.0},
              binding={0: 0, 1: 1, 2: 2}, deps=[(0, 2, 3.0), (1, 2, 5.0)])
    sg = build_stage_graph(**kw)
    assert sg.latency() == pytest.approx(19.0)
    assert sg.throughput() == pytest.approx(1 / 10.0)
    assert sg.total_time(ticks=4) == pytest.approx(19.0 + 3 * 10.0)
    ref = ref_pm.build_stage_graph(**kw)
    assert (sg.latency(), sg.throughput(), sg.total_time(4)) \
        == (ref.latency(), ref.throughput(), ref.total_time(4))
    assert [(s.name, s.delay, s.kind) for s in sg.stages] \
        == [(s.name, s.delay, s.kind) for s in ref.stages]


def test_shared_chiplet_merges_stages():
    kw = dict(compute_delays={0: 10.0, 1: 8.0, 2: 6.0},
              binding={0: 0, 1: 0, 2: 1}, deps=[(0, 2, 3.0), (1, 2, 3.0)])
    sg = build_stage_graph(**kw)
    assert sg.latency() == pytest.approx(27.0)
    assert sg.latency() == ref_pm.build_stage_graph(**kw).latency()


def test_stage_graph_rejects_a_cycle():
    from repro_torch.core.perf_model import Stage, StageGraph
    sg = StageGraph([Stage("a", 1.0), Stage("b", 1.0)], [(0, 1), (1, 0)])
    with pytest.raises(ValueError, match="cycle"):
        sg.latency()


@pytest.mark.parametrize("seed", range(4))
def test_simulate_pipeline_equals_reference(seed):
    rng = np.random.default_rng(seed)
    stages = [float(v) for v in rng.uniform(1, 100, 5)]
    transfers = [(int(u), int(v), float(d)) for u, v, d in
                 zip(rng.integers(0, 2, 4), rng.integers(2, 5, 4),
                     rng.uniform(0, 20, 4))]
    assert simulate_pipeline(stages, transfers) \
        == ref_sim.simulate_pipeline(stages, transfers)


# ---------------------------------------------------------------------------
# the systolic simulator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bw", [128.0, 16.0])
def test_simulate_matmul_equals_reference(bw):
    for (M, N, K) in SHAPES:
        for arr in ((8, 8), (4, 16)):
            got = simulate_matmul(M, N, K, SystolicConfig(
                *arr, dram_bw_gbps=bw))
            ref = ref_sim.simulate_matmul(M, N, K, ref_sim.SystolicConfig(
                *arr, dram_bw_gbps=bw))
            assert got == ref


def _analytical(analyze, mm, tensor, M, N, K, bw):
    """One 8x8 core with the whole matmul as its chiplet tile, through a
    package's ``analyze_chiplet`` (``mm`` its ``matmul``, ``tensor`` its
    array constructor)."""
    wl = {k: tensor(v) for k, v in mm("mm", M, N, K).to_arrays().items()}
    args = [tensor(np.asarray(a, np.int32)) for a in (
        [8, 8, 1, 1, 1, 1], [0, 1, 0, 1, 0, 1],
        [[0, 1, 2, 3, 4, 5, 6, 7]] * 3,
        [[8, 8, K] + [1] * 5, [M, N, K] + [1] * 5])]
    an = analyze(wl, *args, ext_bw_gbps=tensor(np.float32(bw)))
    return float(an["delay_ns"])


def test_analytical_vs_systolic_simulator():
    """Sec. V-A: analytical latency within ~10% of the cycle-approximate
    systolic simulation for compute-bound matmuls on an 8x8 array — and
    the port's analytical latency is the reference's."""
    errs = []
    for (M, N, K) in [(128, 128, 128), (256, 256, 256), (512, 512, 128)]:
        sim = simulate_matmul(M, N, K, SystolicConfig(8, 8))
        got = _analytical(analyze_chiplet, matmul, torch.as_tensor,
                          M, N, K, 128.0)
        ref = _analytical(ref_analyze, ref_matmul, jnp.asarray,
                          M, N, K, 128.0)
        assert got == pytest.approx(ref, rel=1e-5)
        errs.append(abs(got - sim["latency_ns"]) / sim["latency_ns"])
    assert np.mean(errs) < 0.12, errs


# ---------------------------------------------------------------------------
# Map / Bind / Reduce + Omega (element-level oracle for the fast evaluator)
# ---------------------------------------------------------------------------
def test_map_instances_modulo():
    w = matmul("mm", 4, 4, 2)
    cl = mapping.Cluster({"pe": (2, 2)})
    coords = mapping.map_instances(w, cl, {"pe": ("i", "j")})
    inst = mapping.enumerate_instances(w)
    assert np.all(coords[:, 0] == inst[:, 0] % 2)
    assert np.all(coords[:, 1] == inst[:, 1] % 2)
    ref = ref_mapping.map_instances(ref_matmul("mm", 4, 4, 2),
                                    ref_mapping.Cluster({"pe": (2, 2)}),
                                    {"pe": ("i", "j")})
    np.testing.assert_array_equal(coords, ref)


def test_reduce_gathers_by_core():
    w = matmul("mm", 4, 4, 1)
    cl = mapping.Cluster({"core": (2, 2)})
    coords = mapping.map_instances(w, cl, {"core": ("i", "j")})
    groups = mapping.reduce_graph(coords)
    assert len(groups) == 4
    assert sum(len(v) for v in groups.values()) == w.macs
    ref = ref_mapping.reduce_graph(coords)
    assert groups.keys() == ref.keys()
    for k in groups:
        np.testing.assert_array_equal(groups[k], ref[k])


@pytest.mark.parametrize("m,n,k,n2", [(2, 3, 4, 5), (6, 2, 2, 3),
                                      (3, 5, 6, 2), (4, 4, 4, 4)])
def test_omega_matches_tensor_size(m, n, k, n2):
    """|Omega| equals the producer tensor size the fast evaluator uses as
    transfer volume, and the pairs are the reference's."""
    a = matmul("a", m, n, k)
    b = matmul("b", m, n2, n)
    pairs = mapping.omega(a, b, "C", "A")
    assert len(pairs) == a.tensor_size("C")
    g = WorkloadGraph([a, b], [Edge(0, 1, "C", "A")])
    assert g.transfer_elems(g.edges[0]) == len(pairs)
    assert pairs == ref_mapping.omega(ref_matmul("a", m, n, k),
                                      ref_matmul("b", m, n2, n), "C", "A")


def test_omega_orders_last_writer_first_reader():
    a = matmul("a", 2, 2, 3)
    b = matmul("b", 2, 2, 2)
    pairs = mapping.omega(a, b, "C", "A")
    inst_a = mapping.enumerate_instances(a)
    inst_b = mapping.enumerate_instances(b)
    for wi, ri in pairs:
        assert inst_a[wi][2] == 2
        el = tuple(inst_a[wi][:2])
        earlier = [j for j in range(ri)
                   if (inst_b[j][0], inst_b[j][2]) == el]
        assert not earlier


def test_bind_sequence():
    bmap = mapping.bind([(0, 0), (0, 1)], [2, 3])
    assert bmap[(0, 0)] == 2 and bmap[(0, 1)] == 3
    assert bmap == ref_mapping.bind([(0, 0), (0, 1)], [2, 3])
