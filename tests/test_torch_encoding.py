"""The port's design-space encoding (``repro_torch.core.encoding``):
``random_design`` / ``mutate`` invariants, and ``feasibility_penalty``
parity with the JAX reference on the same designs (exact: integer
arithmetic, then one float32 division by 64)."""

import jax
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.encoding import feasibility_penalty as ref_penalty

from repro_torch import convert
from repro_torch.core import presets as tp
from repro_torch.core.encoding import (ALL_FIELDS, BO_FIELDS, SA_FIELDS,
                                       DesignSpace, feasibility_penalty,
                                       mutate, random_design)
from repro_torch.core.evaluate import SystemSpec
from repro_torch.core.workload import MAX_LOOPS
from repro_torch.runtime import generator

GRAPHS = {"transformer_block": lambda: tp.transformer_block(),
          "res2": lambda: tp.resnet_convs()["res2"],
          "tt_chain": lambda: tp.tt_chain()}


def _space(name, **kw):
    return DesignSpace(SystemSpec.build(GRAPHS[name](), ch_max=4), **kw)


def _check_invariants(space, d, n):
    W, CH, L = space.W, space.CH, MAX_LOOPS
    mx = torch.as_tensor(space.max_shape)
    nl = torch.as_tensor(space.n_loops).long()
    bounds = torch.as_tensor(space.bounds).long()
    assert d["shape"].shape == (n, W, 6)
    assert bool(((d["shape"] >= 1) & (d["shape"] <= mx)).all())
    assert bool(((d["spatial"] >= 0)
                 & (d["spatial"] < nl.clamp_min(1)[:, None])).all())
    # every order row and the placement stay permutations
    assert torch.equal(d["order"].sort(-1).values,
                       torch.arange(L, dtype=torch.int32).expand(n, W, 3, L))
    assert torch.equal(d["placement"].sort(-1).values,
                       torch.arange(W * CH, dtype=torch.int32).expand(
                           n, W * CH))
    assert bool((d["tiling"] >= 1).all())
    assert bool((d["tiling"] <= bounds.clamp_min(1)[None, :, None, :]).all())
    pipe_ok = (d["pipe"] == L) | ((d["pipe"] >= 0)
                                  & (d["pipe"] < nl.clamp_min(1)))
    assert bool(pipe_ok.all())
    assert bool(((d["logB"] >= 0) & (d["logB"] <= space.max_logB)).all())
    assert bool(((d["packaging"] >= 0) & (d["packaging"] < 3)).all())
    assert bool(((d["family"] >= 0) & (d["family"] < 4)).all())
    assert all(v.dtype == torch.int32 for v in d.values())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_random_design_invariants(name):
    space = _space(name)
    d = random_design(3, space, n=256, device="cpu")
    _check_invariants(space, d, 256)
    one = random_design(3, space, device="cpu")
    assert one["shape"].shape == (space.W, 6) and one["logB"].dim() == 0


@pytest.mark.parametrize("fields", [ALL_FIELDS, SA_FIELDS, BO_FIELDS],
                         ids=["all", "sa", "bo"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mutate_invariants(name, fields):
    space = _space(name)
    gen = generator(11, "cpu")
    d = random_design(gen, space, n=128, device="cpu")
    changed = torch.zeros(128, dtype=torch.bool)
    for _ in range(20):
        nd = mutate(gen, d, space, fields)
        _check_invariants(space, nd, 128)
        # only the fields a move may touch ever change
        allowed = set(fields) | ({"logB"} if "pipe" in fields else set())
        for k in set(nd) - allowed:
            assert torch.equal(nd[k], d[k]), k
        changed |= torch.stack([(nd[k] != d[k]).reshape(128, -1).any(1)
                                for k in nd]).any(0)
        d = nd
    assert bool(changed.float().mean() > 0.5)


def test_fixed_packaging_and_family_respected():
    space = _space("transformer_block", fixed_packaging=2, fixed_family=1)
    gen = generator(5, "cpu")
    d = random_design(gen, space, n=64, device="cpu")
    for _ in range(30):
        d = mutate(gen, d, space, ("packaging", "family"))
    assert bool((d["packaging"] == 2).all()) and bool((d["family"] == 1).all())


def test_no_pipeline_space_never_pipelines():
    space = _space("res2", allow_pipeline=False)
    gen = generator(9, "cpu")
    d = random_design(gen, space, n=64, device="cpu")
    for _ in range(10):
        d = mutate(gen, d, space, ("pipe",))
    assert bool((d["pipe"] == MAX_LOOPS).all()) and bool((d["logB"] == 0).all())


@pytest.mark.parametrize("kw", [{}, {"max_total_pes": 4096}],
                         ids=["free", "pe_budget"])
def test_feasibility_penalty_matches_reference(kw):
    ref_spec = C.SystemSpec.build(C.presets.transformer_block(), ch_max=4)
    ref_space = C.DesignSpace(ref_spec, **kw)
    space = DesignSpace(convert.spec_from_reference(ref_spec), **kw)
    d = random_design(21, space, n=128, device="cpu")
    got = feasibility_penalty(space, d).numpy()
    nd = convert.design_to_numpy(d)
    want = np.asarray(jax.vmap(lambda x: ref_penalty(ref_space, x, None))(
        {k: jax.numpy.asarray(v) for k, v in nd.items()}))
    np.testing.assert_array_equal(got, want)
    assert float(got.max()) > 1.0          # the population has violators


def test_random_design_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_design(0, _space("res2"), n=4)
