"""The front door's tail of the port against the JAX reference, on the CPU:

* ``core.network.topo_code`` equal over every family and node count;
* ``core.cost.monolithic_cost`` within rtol 1e-6 over areas from 1 to
  1200 mm^2 and three techs (the default and two variants of it);
* ``explore.archive.dominates`` equal on seeded pairs, ties included;
* the deprecated ``optimize``, ``two_stage_optimize`` and module-level
  ``explore``: one ``DeprecationWarning`` each and results bit for bit
  those of the port's own ``Session.submit`` on the same key (the cases
  of the reference's ``tests/test_api_shims.py``);
* ``explore.service.default_service``: one process-wide service, a second
  call with kwargs raises.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core import cost as ref_cost
from repro.core import network as ref_network
from repro.explore import archive as ref_archive

from repro_torch import convert
from repro_torch.api import Problem, Query, Session
from repro_torch.core import cost, network
from repro_torch.core.encoding import DesignSpace
from repro_torch.core.evaluate import SystemSpec
from repro_torch.core.optimizer import (SAConfig, optimize,
                                        two_stage_optimize)
from repro_torch.core.workload import WorkloadGraph, matmul
from repro_torch.explore import archive, service
from repro_torch.explore.nsga import NSGAConfig
from repro_torch.explore.service import BudgetPolicy, ExplorationService

TINY = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")
KEY = 3
MONO_RTOL = 1e-6


def test_topo_code_matches_reference_everywhere():
    for fam in range(ref_network.N_FAMILIES):
        for n in range(ref_network.MAX_NODES + 1):
            assert network.topo_code(fam, n) == ref_network.topo_code(fam, n)
    # the code indexes the stacked next-hop tables of both packages
    assert network.topo_code(ref_network.N_FAMILIES - 1,
                             ref_network.MAX_NODES) \
        == len(network.next_hop_tables()) - 1


def _techs():
    base = C.DEFAULT_TECH
    return {"default": base,
            "dear wafers": dataclasses.replace(
                base, wafer_cost=2 * base.wafer_cost,
                defect_density_mm2=3e-3),
            "thin margin": dataclasses.replace(
                base, interposer_margin=1.05, c_substrate_mm2=0.02,
                c_process=11.0, yield_alpha=2.0)}


@pytest.mark.parametrize("tech", list(_techs()))
def test_monolithic_cost_matches_reference(tech):
    ref_tech = _techs()[tech]
    areas = np.linspace(1.0, 1200.0, 997).astype(np.float32)
    want = np.asarray(ref_cost.monolithic_cost(jnp.asarray(areas),
                                               ref_tech))
    got = cost.monolithic_cost(torch.as_tensor(areas),
                               convert.tech_from_reference(ref_tech))
    assert got.dtype == torch.float32 and got.shape == (997,)
    np.testing.assert_allclose(got.numpy(), want, rtol=MONO_RTOL)
    # a scalar area too
    np.testing.assert_allclose(
        float(cost.monolithic_cost(300.0, convert.tech_from_reference(
            ref_tech))),
        float(ref_cost.monolithic_cost(jnp.float32(300.0), ref_tech)),
        rtol=MONO_RTOL)


def test_dominates_matches_reference_on_seeded_pairs():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 3, size=(400, 2, 4)).astype(np.float32)
    pts[:40, 1] = pts[:40, 0]                    # exact ties
    hits = 0
    for a, b in pts:
        want = bool(ref_archive.dominates(jnp.asarray(a), jnp.asarray(b)))
        got = archive.dominates(torch.as_tensor(a), torch.as_tensor(b))
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == want
        hits += want
    assert 0 < hits < len(pts)


def _deprecations(rec):
    return [w for w in rec if issubclass(w.category, DeprecationWarning)
            and str(w.message).startswith("legacy entry point")]


def _spec_space():
    graph = WorkloadGraph([matmul("mm", 512, 512, 64)], [])
    spec = SystemSpec.build(graph, ch_max=2)
    return graph, spec, DesignSpace(spec, **TINY)


def _same_result(a, b):
    assert a.objective == b.objective
    assert a.history == b.history
    for k in a.design:
        assert torch.equal(a.design[k], b.design[k]), k
    for k in a.metrics:
        np.testing.assert_array_equal(np.asarray(a.metrics[k]),
                                      np.asarray(b.metrics[k]))


def test_optimize_shim_warns_once_and_matches_submit(tmp_path):
    _, spec, space = _spec_space()
    kw = dict(weights=(1.0, 1.0, 0.0, 0.0), bo_fields=(), n_init=2,
              sa=SAConfig(steps=10, chains=2))
    with pytest.warns(DeprecationWarning) as rec:
        legacy = optimize(spec, space, KEY, device="cpu", **kw)
    assert len(_deprecations(rec)) == 1
    new = Session(cache_dir=tmp_path / "b", device="cpu").submit(
        Query(Problem.from_spec(spec, space), engine="bo_sa",
              weights=kw["weights"],
              engine_opts=dict(bo_fields=(), n_init=2, sa=kw["sa"])),
        key=KEY)
    assert legacy.objective == new.best_objective
    _same_result(legacy, new.raw)


def test_two_stage_shim_warns_once_and_matches_submit(tmp_path):
    _, spec, space = _spec_space()
    sa = SAConfig(steps=8, chains=2)
    with pytest.warns(DeprecationWarning) as rec:
        legacy = two_stage_optimize(spec, space, KEY, n_candidates=2, sa=sa,
                                    device="cpu")
    assert len(_deprecations(rec)) == 1    # the nested searches run the
    #                                        engine itself, not the shim
    new = Session(cache_dir=tmp_path / "b", device="cpu").submit(
        Query(Problem.from_spec(spec, space), engine="two_stage",
              engine_opts=dict(n_candidates=2, sa=sa)), key=KEY)
    _same_result(legacy, new.raw)


def _svc(tmp_path, sub):
    return ExplorationService(cache_dir=tmp_path / sub,
                              nsga=NSGAConfig(pop=8, generations=2),
                              policy=BudgetPolicy(adaptive=False),
                              device="cpu")


def test_module_level_explore_delegates_with_one_warning(tmp_path):
    graph, _, _ = _spec_space()
    with pytest.warns(DeprecationWarning) as rec:
        r = service.explore(graph, OBJ, budget=16, ch_max=2,
                            space_kwargs=TINY, service=_svc(tmp_path, "a"),
                            key=KEY)
    assert len(_deprecations(rec)) == 1
    new = Session(service=_svc(tmp_path, "b")).submit(
        Query(Problem(graph, OBJ, 2, TINY), budget=16, engine="nsga"),
        key=KEY)
    np.testing.assert_array_equal(r.front_objs, new.raw.front_objs)
    np.testing.assert_array_equal(r.front_metrics, new.raw.front_metrics)
    assert r.n_evals_run == new.raw.n_evals_run == 16
    assert r.cache_key == new.raw.cache_key
    for a, b in zip(r.front_designs, new.raw.front_designs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_default_service_is_one_per_process(tmp_path, monkeypatch):
    monkeypatch.setattr(service, "_DEFAULT", None)
    svc = service.default_service(cache_dir=tmp_path, device="cpu")
    assert service.default_service() is svc
    with pytest.raises(RuntimeError, match="already initialized"):
        service.default_service(cache_dir=tmp_path)
    # the module-level explore answers from it when given no service
    graph, _, _ = _spec_space()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        r = service.explore(graph, OBJ, budget=16, ch_max=2,
                            space_kwargs=TINY, key=KEY)
    assert len(_deprecations(rec)) == 1
    assert r.n_evals_run == 16 and (tmp_path / f"{r.cache_key}.npz").exists()


def test_default_service_refuses_a_missing_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(service, "_DEFAULT", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        service.default_service()
    assert service._DEFAULT is None
