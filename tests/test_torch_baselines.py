"""The port's Simba / NN-Baton / Monad baselines
(``repro_torch.core.baselines``) against the JAX reference, exactly.

On every graph of ``presets.fig7_suite()`` (``ch_max=36``, as the
reference's engine tests build them) and for each baseline, both packages
give the same frozen hardware and mapping strategy (``shape``,
``spatial``, ``packaging``, ``family``; Monad's init is a random design, so
only its space and fields are compared), the same ``DesignSpace`` bounds,
the same ``sa_fields`` / ``bo_fields``, and the iso-PE budget holds
(``tests/test_optimizer_engine.py::test_baselines_iso_pe_budget``)."""

import jax
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.baselines import _spatial_for as ref_spatial_for

from repro_torch.core import presets as tp
from repro_torch.core.baselines import _spatial_for, make_baseline
from repro_torch.core.evaluate import SystemSpec

NAMES = ("simba", "nn-baton", "monad")
FROZEN = ("shape", "spatial", "packaging", "family")
BOUNDS = ("max_shape", "max_logB", "max_total_pes", "fixed_packaging",
          "fixed_family", "allow_pipeline")
GRAPHS = sorted(C.presets.fig7_suite())


@pytest.mark.parametrize("graph", GRAPHS)
def test_baselines_match_reference(graph):
    rspec = C.SystemSpec.build(C.presets.fig7_suite()[graph], ch_max=36)
    spec = SystemSpec.build(tp.fig7_suite()[graph], ch_max=36)
    for kind in ("channels", "plane"):
        np.testing.assert_array_equal(_spatial_for(spec.graph, kind),
                                      ref_spatial_for(rspec.graph, kind))
    for name in NAMES:
        want = C.make_baseline(name, rspec, jax.random.PRNGKey(0))
        got = make_baseline(name, spec, 0, device="cpu")
        assert got.name == want.name
        assert got.sa_fields == want.sa_fields
        assert got.bo_fields == want.bo_fields
        for b in BOUNDS:
            assert getattr(got.space, b) == getattr(want.space, b), (name, b)
        assert set(got.init) == set(want.init)
        for k, v in got.init.items():
            assert v.dtype == torch.int32 and v.device.type == "cpu"
            assert tuple(v.shape) == np.shape(want.init[k]), (name, k)
        if name == "monad":
            continue
        for f in FROZEN:
            np.testing.assert_array_equal(got.init[f].numpy(),
                                          np.asarray(want.init[f]),
                                          err_msg=f"{name} {f}")
        pes = int(got.init["shape"].long().prod(-1).sum())
        assert pes <= 4096 * 1.5, (name, pes)
        assert got.space.fixed_packaging >= 0     # integration frozen


def test_unknown_baseline_raises():
    spec = SystemSpec.build(tp.bert_mms()["att2"], ch_max=4)
    with pytest.raises(ValueError):
        make_baseline("eyeriss", spec, 0, device="cpu")
