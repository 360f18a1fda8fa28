"""The port's NSGA-II loop (``repro_torch.explore.nsga``) and the service's
plateau memory: output shapes and telemetry invariants of a run, seeded
determinism, PMX validity, and ``PlateauState`` against the reference on
the same hypervolume sequence."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import numpy as np
import pytest
import torch

from repro.explore.service import PlateauState as RefPlateauState

from repro_torch.core import presets as tp
from repro_torch.core.encoding import DesignSpace, random_design
from repro_torch.core.evaluate import SystemSpec
from repro_torch.explore.archive import ConvergenceTrace
from repro_torch.explore.nsga import NSGAConfig, make_nsga, pmx
from repro_torch.explore.service import PlateauState
from repro_torch.runtime import generator

OBJ = ("latency_ns", "cost_usd")


def _setup(pop=16, generations=4, **kw):
    spec = SystemSpec.build(tp.transformer_block(), ch_max=4)
    space = DesignSpace(spec)
    run = make_nsga(spec, space, OBJ,
                    NSGAConfig(pop=pop, generations=generations, **kw),
                    device="cpu")
    return space, run, random_design(0, space, n=pop, device="cpu")


def test_run_shapes_and_telemetry():
    space, run, pop0 = _setup()
    pop, raw, sel, ev_d, ev_raw, ev_feas, tr = run(1, pop0)
    assert pop["placement"].shape == (16, space.W * space.CH)
    assert raw.shape == (16, 4) and sel.shape == (16, 2)
    assert ev_d["order"].shape == (4, 16, space.W, 3, 8)
    assert ev_raw.shape == (4, 16, 4) and ev_feas.shape == (4, 16)
    trace = ConvergenceTrace.from_scan(OBJ, tr, 16)
    assert trace.generations == 4 and trace.n_evals[-1] == 64
    assert np.all(np.diff(trace.hypervolume[:, 0]) >= 0)   # running max
    assert np.all(np.diff(trace.best) <= 0)                # running min
    assert np.all(trace.hv_gen <= trace.hypervolume + 1e-9)
    # survivors are the best of each generation's pool: all evaluated
    assert bool(torch.isfinite(raw).all())


def test_same_seed_same_run():
    _, run, pop0 = _setup()
    a, b = run(7, pop0), run(7, pop0)
    for x, y in zip(a[:3], b[:3]):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        else:
            assert torch.equal(x, y)
    c = run(8, pop0)
    assert not torch.equal(a[1], c[1])


def test_pmx_placement_run_keeps_permutations():
    space, run, pop0 = _setup(pmx_placement=True, crossover_rate=0.9)
    pop = run(2, pop0)[0]
    n = space.W * space.CH
    assert torch.equal(pop["placement"].sort(-1).values,
                       torch.arange(n, dtype=torch.int32).expand(16, n))


def test_pmx_carries_the_segment_and_stays_a_permutation():
    gen = generator(3, "cpu")
    n, P = 12, 256
    a = torch.argsort(torch.rand(P, n, generator=gen), -1)
    b = torch.argsort(torch.rand(P, n, generator=gen), -1)
    c = pmx(generator(4, "cpu"), a, b)
    assert torch.equal(c.sort(-1).values, torch.arange(n).expand(P, n))
    # each child agrees with b on a contiguous segment and is a's
    # permutation elsewhere; some children really mix both parents
    mixed = ((c != a).any(1) & (c != b).any(1)).float().mean()
    assert float(mixed) > 0.3


@pytest.mark.parametrize("seq", [
    [1.0, 1.001, 1.002, 1.0021],
    [0.0, 0.0, 5.0, 5.0, 5.0],
    [2.0, 3.0, 3.0, 3.0001, 10.0, 10.0]])
def test_plateau_state_matches_reference(seq):
    a, b = PlateauState(), RefPlateauState()
    for i, v in enumerate(seq):
        count = i != 1
        assert a.observe([v, v / 2], 0.005, count=count) \
            == b.observe([v, v / 2], 0.005, count=count)
