"""The port's Matérn-5/2 covariance against the JAX reference.

The plain PyTorch version (``repro_torch.kernels.gp_cov.ref``, what
``ops.matern52`` runs for a CPU tensor) is held to the reference's jnp
oracle, to the reference engine's own ``optimizer.matern52`` and to the
Pallas kernel run in interpret mode, at the cases of
``tests/test_kernels.py`` (three shapes x three lengthscales) plus the BO
engine's acquisition shape (512 candidates x 11 observations x 62
features), at atol = rtol = 1e-5 (the reference kernel test's tolerance:
float32 sums taken in another order).  The CUDA kernel itself is held
against the same plain version on the card (``test_torch_cuda.py`` and
``chip_smoke.py``)."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.optimizer import matern52 as ref_engine_matern52
from repro.kernels.gp_cov.gp_cov import matern52_pallas
from repro.kernels.gp_cov.ref import matern52_ref as jax_ref

from repro_torch.core.optimizer import matern52 as port_engine_matern52
from repro_torch.kernels.gp_cov import ops
from repro_torch.kernels.gp_cov.ref import matern52_ref

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(16, 16, 4, 8), (32, 24, 7, 8), (64, 64, 12, 32),
          (512, 11, 62, 128)]


def _points(n, m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("ls", [0.1, 0.5, 2.0])
@pytest.mark.parametrize("n,m,d,blk", SHAPES)
def test_plain_matches_reference_and_pallas(n, m, d, blk, ls):
    x1, x2 = _points(n, m, d, seed=n + m + d)
    got = matern52_ref(torch.as_tensor(x1), torch.as_tensor(x2), ls).numpy()
    assert got.dtype == np.float32 and got.shape == (n, m)
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    for want in (jax_ref(j1, j2, ls), ref_engine_matern52(j1, j2, ls),
                 matern52_pallas(j1, j2, ls, block=blk, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_engine_and_wrapper_take_the_plain_version_on_the_cpu():
    x1, x2 = _points(40, 9, 62, seed=3)
    t1, t2 = torch.as_tensor(x1), torch.as_tensor(x2)
    before = ops.matern52.launches
    want = matern52_ref(t1, t2, 0.3)
    assert torch.equal(ops.matern52(t1, t2, 0.3), want)
    assert torch.equal(port_engine_matern52(t1, t2, 0.3), want)
    assert ops.matern52.launches == before        # no kernel on the CPU


def test_row_chunks_do_not_change_the_result():
    x1, x2 = _points(70, 33, 62, seed=4)
    t1, t2 = torch.as_tensor(x1), torch.as_tensor(x2)
    np.testing.assert_array_equal(
        matern52_ref(t1, t2, 0.7, chunk_elems=33 * 62 * 3).numpy(),
        matern52_ref(t1, t2, 0.7).numpy())


def test_unit_diagonal_symmetric_and_psd():
    x, _ = _points(24, 1, 5, seed=1)
    K = matern52_ref(torch.as_tensor(x), torch.as_tensor(x), 0.7).numpy()
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-5)
    np.testing.assert_allclose(K, K.T, atol=1e-6)
    assert np.linalg.eigvalsh(K + 1e-6 * np.eye(24)).min() > 0


def test_nearby_points_keep_their_distance():
    """Direct differences: a 1e-3 perturbation in 62 dimensions is seen as
    such (for this pair the |x|^2 + |z|^2 - 2x.z form, evaluated in
    float32, is ~8% off in d^2 from cancellation)."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 62)).astype(np.float32)
    z = (x + 1e-3 * rng.standard_normal((1, 62))).astype(np.float32)
    d = float(np.linalg.norm(x.astype(np.float64) - z.astype(np.float64)))
    r = d / 0.3
    want = (1 + np.sqrt(5) * r + 5 * r * r / 3) * np.exp(-np.sqrt(5) * r)
    got = matern52_ref(torch.as_tensor(x), torch.as_tensor(z), 0.3).item()
    assert abs(got - want) <= 1e-6
