"""The port's evaluator (``repro_torch.core``) against the JAX reference.

* the golden 4-metric vectors of ``tests/test_golden_metrics.py`` on the
  port's own graphs, at the same rtol 1e-4;
* the jacobian of the four metrics w.r.t. every fittable tech field, the
  fields given as 0-d tensors (the calibration slice differentiates
  through them), against ``jax.jacfwd`` of the reference at rtol 1e-4;
* random populations drawn by the reference's ``random_design``, carried
  over with ``repro_torch.convert``, through ``repro.core.make_batch_evaluator``
  and the port's ``make_batch_evaluator`` on the CPU: every ``METRIC_KEYS``
  column and ``feasibility_penalty`` at rtol 1e-4 (float32 pipelines that
  reassociate a few sums; the golden table uses the same bound).

The Fig. 7 suite's graphs live in ``test_torch_evaluator_fig7.py`` (one
JAX compile per graph; split so each file stays short).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.constants import DEFAULT_TECH as REF_TECH
from repro.core.constants import FITTABLE_FIELDS, METRIC_FIELDS
from repro.core.evaluate import evaluate_system as ref_evaluate_system
from repro.core.encoding import feasibility_penalty as ref_penalty
from repro.core.encoding import random_design as ref_random_design
from test_golden_metrics import GOLDEN, _fixed_design

from repro_torch import convert
from repro_torch.core import presets as tp
from repro_torch.core.constants import DEFAULT_TECH
from repro_torch.core.encoding import DesignSpace, feasibility_penalty
from repro_torch.core.evaluate import (SystemSpec, evaluate_system,
                                       make_batch_evaluator)
from repro_torch.core.optimizer import METRIC_KEYS, metric_stack

RTOL = 1e-4
POP = 32


def _port_graph(name):
    if name == "att2":
        return tp.bert_mms()["att2"]
    if name == "res2":
        return tp.resnet_convs()["res2"]
    return tp.transformer_block()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_matches_golden(name):
    spec = SystemSpec.build(_port_graph(name), ch_max=2)
    fixed = _fixed_design(spec)
    design = convert.design_to_torch(
        {k: np.asarray(v)[None] for k, v in fixed.items()}, device="cpu")
    metrics = evaluate_system(spec, design)
    got = metric_stack(metrics)[0].double().numpy()
    np.testing.assert_allclose(got, np.asarray(GOLDEN[name]), rtol=RTOL,
                               err_msg=f"METRIC_KEYS={METRIC_KEYS}")
    pen = feasibility_penalty(DesignSpace(spec), design, metrics)
    assert float(pen[0]) == pytest.approx(1.0)


def test_tech_jacobian_matches_reference():
    ref_spec = C.SystemSpec.build(C.presets.transformer_block(), ch_max=2)
    fixed = _fixed_design(ref_spec)
    ref_base = dataclasses.replace(REF_TECH, t_tile_overhead_ns=8.0)

    def ref_metrics(vals):
        tech = dataclasses.replace(ref_base, **dict(zip(FITTABLE_FIELDS,
                                                        vals)))
        out = ref_evaluate_system(ref_spec, fixed, tech=tech)
        return jnp.stack([out[k] for k in METRIC_KEYS])

    v0 = np.asarray([float(getattr(ref_base, f)) for f in FITTABLE_FIELDS],
                    np.float32)
    want = np.asarray(jax.jit(jax.jacfwd(ref_metrics))(jnp.asarray(v0)))

    spec = convert.spec_from_reference(ref_spec)
    design = convert.design_to_torch(
        {k: np.asarray(v)[None] for k, v in fixed.items()}, device="cpu")
    base = dataclasses.replace(DEFAULT_TECH, t_tile_overhead_ns=8.0)

    def port_metrics(vals):
        tech = dataclasses.replace(base, **{
            f: vals[i] for i, f in enumerate(FITTABLE_FIELDS)})
        return metric_stack(evaluate_system(spec, design, tech))[0]

    got = torch.autograd.functional.jacobian(
        port_metrics, torch.as_tensor(v0)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    for metric, fields in METRIC_FIELDS.items():
        for f in fields:
            assert got[METRIC_KEYS.index(metric),
                       FITTABLE_FIELDS.index(f)] != 0.0, (metric, f)


_SAMPLERS = {}


def _ref_population(space, seed, pop):
    """``pop`` designs from the reference's ``random_design``, jitted once
    per padded shape (loop counts and bounds are runtime operands, as in
    the reference's own immigrant sampler)."""
    shape_key = (space.W, space.CH)
    if shape_key not in _SAMPLERS:
        _SAMPLERS[shape_key] = jax.jit(jax.vmap(
            lambda k, nl, b: ref_random_design(k, space, nl=nl, bounds=b),
            in_axes=(0, None, None)))
    keys = jax.random.split(jax.random.PRNGKey(seed), pop)
    return _SAMPLERS[shape_key](keys, space.n_loops, space.bounds)


def population_parity(ref_graph, ch_max, seed=0, pop=POP):
    """Hold the port's evaluator against the reference's on one random
    population drawn by the reference."""
    spec = C.SystemSpec.build(ref_graph, ch_max=ch_max)
    space = C.DesignSpace(spec)
    designs = _ref_population(space, seed, pop)
    ref_m = C.make_batch_evaluator(spec)(designs)
    ref_pen = np.asarray(jax.jit(jax.vmap(
        lambda d: ref_penalty(space, d, None)))(designs))

    port_spec = convert.spec_from_reference(spec)
    port_space = DesignSpace(port_spec)
    td = convert.design_to_torch(designs, device="cpu")
    m = make_batch_evaluator(port_spec, device="cpu")(td)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(m[k].double().numpy(),
                                   np.asarray(ref_m[k], np.float64),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(
        feasibility_penalty(port_space, td, m).double().numpy(),
        ref_pen.astype(np.float64), rtol=RTOL)


def test_random_population_transformer_block():
    population_parity(C.presets.transformer_block(), ch_max=4)


@pytest.mark.parametrize("name", sorted(C.presets.validation_suite()))
def test_random_population_validation_suite(name):
    population_parity(C.presets.validation_suite()[name], ch_max=4)


def test_evaluator_refuses_cuda_without_a_card():
    """The entry point defaults to the card and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = SystemSpec.build(tp.bert_mms()["att2"], ch_max=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch_evaluator(spec)
