"""The port's archive math (``repro_torch.explore.archive``) against the JAX
reference on the same numpy pools.

Randomized pools are built with many exact ties (values drawn from a small
grid, duplicated rows), where a non-stable sort or an off-by-one in the
boundary rules would pick different rows than the reference.  Crowding
distance, the fixed-shape hypervolume, ``ParetoArchive.insert`` and one
NSGA selection step must agree exactly."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Problem as RefProblem
from repro.core import SystemSpec as RefSpec, DesignSpace as RefSpace
from repro.core import presets as ref_presets
from repro.explore import archive as ref

from repro_torch import convert
from repro_torch.api import Problem
from repro_torch.core import presets as tp
from repro_torch.core.encoding import DesignSpace
from repro_torch.explore import archive as port

BIG = 1e30


def _tied_pool(n, k, seed, frac=0.8):
    rng = np.random.default_rng(seed)
    objs = rng.integers(0, 6, size=(n, k)).astype(np.float32) \
        + rng.integers(0, 2, size=(n, 1)).astype(np.float32) * 0.5
    objs[n // 3:n // 3 + 5] = objs[:5]
    valid = rng.random(n) < frac
    return objs, valid


POOLS = [(32, 2, 0), (128, 2, 1), (97, 3, 2), (256, 4, 3), (768, 4, 4),
         (16, 1, 5)]


@pytest.mark.parametrize("n,k,seed", POOLS)
def test_crowding_distance_exact(n, k, seed):
    objs, valid = _tied_pool(n, k, seed)
    want = np.asarray(ref.crowding_distance(jnp.asarray(objs),
                                            jnp.asarray(valid)))
    got = port.crowding_distance(torch.as_tensor(objs),
                                 torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(8, 0), (64, 1), (128, 2), (500, 3)])
def test_hypervolume_2d_jit_exact(n, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 40, size=(n, 2)) * 0.75).astype(np.float32)
    pts[:3] = [np.inf, 1.0], [50.0, 2.0], [1.0, np.nan]   # filtered rows
    valid = rng.random(n) < 0.9
    refp = (41.0, 41.0)
    want = float(ref.hypervolume_2d_jit(jnp.asarray(pts), refp,
                                        valid=jnp.asarray(valid)))
    got = float(port.hypervolume_2d_jit(torch.as_tensor(pts), refp,
                                        valid=torch.as_tensor(valid)))
    assert got == want
    # and the exact float64 staircase agrees with both
    host = port.hypervolume_2d(pts[valid], refp)
    assert host == pytest.approx(want, rel=1e-6)


def _template(W=2, CH=2, L=8):
    return dict(shape=np.zeros((W, 6), np.int32),
                order=np.zeros((W, 3, L), np.int32),
                logB=np.zeros((), np.int32),
                placement=np.zeros((W * CH,), np.int32))


def _designs(m, rng):
    t = _template()
    return {k: rng.integers(0, 50, size=(m,) + v.shape).astype(np.int32)
            for k, v in t.items()}


@pytest.mark.parametrize("capacity,k,seed", [(16, 2, 0), (64, 4, 1),
                                             (256, 4, 2)])
def test_archive_insert_exact(capacity, k, seed):
    """The same insert sequence leaves both archives in the same state:
    objectives, validity and designs, row for row."""
    rng = np.random.default_rng(seed)
    a_ref = ref.ParetoArchive(capacity, _template(), n_obj=k)
    a_port = port.ParetoArchive(capacity, _template(), n_obj=k,
                                device="cpu")
    for step in range(6):
        m = int(rng.integers(8, 3 * capacity))
        objs, valid = _tied_pool(m, k, seed * 100 + step)
        objs[rng.random(m) < 0.05] = np.inf       # non-finite rows drop
        designs = _designs(m, rng)
        a_ref.insert(designs, objs, mask=valid)
        a_port.insert(designs, objs, mask=valid)
        np.testing.assert_array_equal(a_port.objs.numpy(), a_ref.objs)
        np.testing.assert_array_equal(a_port.valid.numpy(), a_ref.valid)
        for key in a_ref.designs:
            np.testing.assert_array_equal(a_port.designs[key].numpy(),
                                          a_ref.designs[key])
        assert a_port.n_evals == a_ref.n_evals and len(a_port) == len(a_ref)
    np.testing.assert_array_equal(a_port.front()[1], a_ref.front()[1])
    if k >= 2:
        assert a_port.projected_hypervolume((0, 1)) \
            == a_ref.projected_hypervolume((0, 1))


def test_port_loads_reference_archive(tmp_path):
    rng = np.random.default_rng(9)
    a_ref = ref.ParetoArchive(64, _template(), n_obj=4,
                              obj_keys=("latency_ns", "energy_pj",
                                        "cost_usd", "area_mm2"))
    objs, valid = _tied_pool(200, 4, 9)
    a_ref.insert(_designs(200, rng), objs, mask=valid)
    a_ref.searched = ("latency_ns", "cost_usd")
    a_ref.budget_covered = 2048
    a_ref.trace_summary = {"generations": 3}
    path = a_ref.save(tmp_path / "ref.npz")
    a = port.ParetoArchive.load(path, device="cpu")
    assert (a.capacity, a.n_obj, a.obj_keys) == (64, 4, a_ref.obj_keys)
    assert (a.n_evals, a.searched, a.budget_covered, a.trace_summary) == (
        a_ref.n_evals, a_ref.searched, 2048, {"generations": 3})
    np.testing.assert_array_equal(a.objs.numpy(), a_ref.objs)
    np.testing.assert_array_equal(a.valid.numpy(), a_ref.valid)
    for key, v in a_ref.designs.items():
        np.testing.assert_array_equal(a.designs[key].numpy(), v)
    # and a port-written archive loads back identically
    a2 = port.ParetoArchive.load(a.save(tmp_path / "port.npz"), device="cpu")
    np.testing.assert_array_equal(a2.objs.numpy(), a_ref.objs)


@pytest.mark.parametrize("n,k,seed", [(128, 2, 0), (128, 3, 1),
                                      (64, 2, 2)])
def test_selection_step_picks_reference_survivors(n, k, seed):
    """One NSGA environmental-selection step (dominance counts, crowding
    tie-break, stable argsort of the key) keeps the same survivors."""
    objs, _ = _tied_pool(n, k, seed)
    objs[np.random.default_rng(seed).random(n) < 0.1] = np.inf
    fin = np.all(np.isfinite(objs), -1)
    sane = np.where(np.isfinite(objs), objs, np.float32(BIG))

    j_sane, j_fin = jnp.asarray(sane), jnp.asarray(fin)
    nd = ref.dominance_counts(j_sane, j_fin)
    crowd = ref.crowding_distance(j_sane, j_fin)
    keyv = jnp.where(j_fin, nd.astype(jnp.float32) * 1e6
                     - jnp.minimum(crowd, 1e5), BIG)
    want = np.asarray(jnp.argsort(keyv)[:n // 2])

    t_sane, t_fin = torch.as_tensor(sane), torch.as_tensor(fin)
    ndt = port.dominance_counts(t_sane, t_fin)
    crt = port.crowding_distance(t_sane, t_fin)
    kt = torch.where(t_fin, ndt.float() * 1e6 - crt.clamp(max=1e5), BIG)
    got = torch.argsort(kt, stable=True)[:n // 2].numpy()
    np.testing.assert_array_equal(got, want)


def test_problem_and_space_keys_match_reference():
    """The port's content hashes equal the reference's; only the service
    salt keeps their cache files apart."""
    g = ref_presets.transformer_block()
    assert Problem(tp.transformer_block()).key() == RefProblem(g).key()
    spec = RefSpec.build(g, ch_max=4)
    pspec = convert.spec_from_reference(spec)
    assert port.spec_space_key(pspec, DesignSpace(pspec)) \
        == ref.spec_space_key(spec, RefSpace(spec))
    assert port.spec_space_key(pspec, DesignSpace(pspec), extra="x") \
        != ref.spec_space_key(spec, RefSpace(spec))


def test_convergence_trace_extend_and_summary():
    tr = {"front_size": np.array([1, 2]), "hypervolume": np.array([[1.], [2.]]),
          "best": np.array([3., 2.]), "feasible_frac": np.array([.5, 1.]),
          "hv_now": np.array([[1.], [2.]])}
    a = port.ConvergenceTrace.from_scan(("latency_ns", "cost_usd"), tr, 8)
    b = ref.ConvergenceTrace.from_scan(("latency_ns", "cost_usd"), tr, 8)
    a2, b2 = a.extend(a), b.extend(b)
    assert a2.summary() == b2.summary()
    np.testing.assert_array_equal(a2.n_evals, b2.n_evals)
    np.testing.assert_array_equal(a2.hypervolume, b2.hypervolume)
    assert port.objective_pairs(4) == ref.objective_pairs(4)
