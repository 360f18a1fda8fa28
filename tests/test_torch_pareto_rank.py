"""The port's dominance counts against the JAX reference, exactly.

The plain PyTorch version (``repro_torch.kernels.pareto_rank.ref``, what
``ops.dominance_counts`` runs for a CPU tensor) is held to integer equality
with the reference's jnp oracle and with the Pallas kernel run in interpret
mode, at the cases of ``tests/test_kernels.py``: duplicated rows for ties,
a ragged 190-row pool and an all-invalid pool; then pools with NaN and
+-inf objectives.  The kernel's arithmetic on finite tiles (differences'
bit patterns ORed, ``ref.dominance_counts_bits_mirror``) is held to the
reference on finite pools built to break it: +-0, +-FLT_MAX whose
differences overflow, adjacent floats and exact ties; and, on subnormals,
to the port's plain version.  The CUDA kernel itself is
held against the same plain version on the card (``test_torch_cuda.py``
and ``chip_smoke.py``)."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.explore.archive import dominance_counts as ref_archive_counts
from repro.kernels.pareto_rank.pareto_rank import dominance_counts_pallas
from repro.kernels.pareto_rank.ref import dominance_counts_ref as jax_ref

from repro_torch.explore import archive as port_archive
from repro_torch.kernels.pareto_rank import ops
from repro_torch.kernels.pareto_rank.ref import (dominance_counts_bits_mirror,
                                                 dominance_counts_ref)


def _pool(n, k, seed, frac=0.8, dup=8):
    rng = np.random.default_rng(seed)
    objs = rng.standard_normal((n, k)).astype(np.float32)
    objs[n // 2:n // 2 + dup] = objs[:dup]       # exact ties
    valid = rng.random(n) < frac
    return objs, valid


def _port(objs, valid, fn=dominance_counts_ref):
    return fn(torch.as_tensor(objs), torch.as_tensor(valid)).numpy()


@pytest.mark.parametrize("n,k,blk", [(128, 2, 128), (256, 4, 128),
                                     (64, 3, 64), (200, 4, 64)])
def test_plain_matches_reference_and_pallas(n, k, blk):
    objs, valid = _pool(n, k, seed=n + k)
    want = np.asarray(jax_ref(jnp.asarray(objs), jnp.asarray(valid)))
    pn = (-n) % blk
    pallas = np.asarray(dominance_counts_pallas(
        jnp.pad(jnp.asarray(objs), ((0, pn), (0, 0))),
        jnp.pad(jnp.asarray(valid), (0, pn)), block=blk,
        interpret=True)[:n])
    got = _port(objs, valid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_ragged_pool_matches_reference():
    objs, valid = _pool(190, 3, seed=7, frac=0.9)
    want = np.asarray(jax_ref(jnp.asarray(objs), jnp.asarray(valid)))
    np.testing.assert_array_equal(_port(objs, valid, ops.dominance_counts),
                                  want)


def test_all_invalid_is_zero():
    objs, _ = _pool(64, 2, seed=3)
    valid = np.zeros(64, bool)
    want = np.asarray(dominance_counts_pallas(
        jnp.asarray(objs), jnp.asarray(valid), block=64, interpret=True))
    got = _port(objs, valid)
    assert int(got.sum()) == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [1, 7, 1024])
def test_chunking_does_not_change_counts(chunk):
    objs, valid = _pool(300, 4, seed=11)
    t_objs, t_valid = torch.as_tensor(objs), torch.as_tensor(valid)
    np.testing.assert_array_equal(
        dominance_counts_ref(t_objs, t_valid, chunk=chunk).numpy(),
        np.asarray(jax_ref(jnp.asarray(objs), jnp.asarray(valid))))


def test_archive_routes_cpu_pools_to_the_plain_version():
    """``archive.dominance_counts`` funnels every pool through the kernel
    wrapper; on the CPU that is the plain version and launches nothing."""
    objs, valid = _pool(768, 4, seed=5)
    before = ops.dominance_counts.launches
    got = port_archive.dominance_counts(torch.as_tensor(objs),
                                        torch.as_tensor(valid)).numpy()
    assert ops.dominance_counts.launches == before
    np.testing.assert_array_equal(
        got, np.asarray(jax_ref(jnp.asarray(objs), jnp.asarray(valid))))


def test_wrapper_refuses_other_devices():
    objs = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.dominance_counts(objs, torch.ones(4, dtype=torch.bool,
                                              device="meta"))


def _special_pool(n, k, seed, frac, values):
    """A pool drawn from ``values`` with a normal row every 7th, exact
    ties, and ``frac`` of the rows valid."""
    rng = np.random.default_rng(seed)
    objs = rng.choice(np.asarray(values, np.float32), (n, k))
    objs[::7] = rng.standard_normal((len(objs[::7]), k))
    objs[n // 2:n // 2 + 8] = objs[:8]           # exact ties
    return objs.astype(np.float32), rng.random(n) < frac


NONFINITE = (np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 2.0)


@pytest.mark.parametrize("n,k,frac", [(64, 2, 0.9), (200, 4, 0.8),
                                      (256, 3, 1.0), (130, 1, 0.5),
                                      (96, 4, 0.0)])
def test_nonfinite_pools_match_reference(n, k, frac):
    """NaN dominates nothing and is dominated by nothing; +-inf compare as
    IEEE orders them: the port's plain version (the wrapper's CPU path),
    the reference's oracle, its archive entry point and its Pallas kernel
    in interpret mode give the same integers."""
    objs, valid = _special_pool(n, k, seed=n * k, frac=frac,
                                values=NONFINITE)
    want = np.asarray(jax_ref(jnp.asarray(objs), jnp.asarray(valid)))
    pn = (-n) % 64
    pallas = np.asarray(dominance_counts_pallas(
        jnp.pad(jnp.asarray(objs), ((0, pn), (0, 0))),
        jnp.pad(jnp.asarray(valid), (0, pn)), block=64,
        interpret=True)[:n])
    archive = np.asarray(ref_archive_counts(jnp.asarray(objs),
                                            jnp.asarray(valid)))
    got = _port(objs, valid, ops.dominance_counts)
    for ref in (want, pallas, archive):
        np.testing.assert_array_equal(got, ref)
    if frac == 0.0:
        assert int(got.sum()) == 0


FINITE_EDGES = (0.0, -0.0, 3.4028235e38, -3.4028235e38, 1.0,
                float(np.nextafter(np.float32(1.0), np.float32(2.0))),
                -1.0, 2.0)
SUBNORMALS = (1e-45, -1e-45, 1.2e-38, 0.0, -0.0)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_bits_mirror_matches_reference_on_finite_edge_pools(k, seed):
    """The kernel's finite-tile test — OR of the bit patterns of o_j - o_i
    positive as int32 — is exact on finite pools: -0 against +0 (staged
    as +0), differences that overflow to +-inf, adjacent floats and exact
    ties; against the reference's oracle and the port's plain version."""
    objs, valid = _special_pool(300, k, seed=seed * 10 + k, frac=0.8,
                                values=FINITE_EDGES)
    want = np.asarray(jax_ref(jnp.asarray(objs), jnp.asarray(valid)))
    t_objs, t_valid = torch.as_tensor(objs), torch.as_tensor(valid)
    got = dominance_counts_bits_mirror(t_objs, t_valid).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, dominance_counts_ref(t_objs, t_valid).numpy())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bits_mirror_keeps_subnormals_apart(k):
    """Subnormal differences are not flushed to zero, so the mirror (and
    the kernel, built without flush-to-zero) agrees with the port's plain
    version, which compares subnormals exactly as the card does.  The
    reference is not asked here: XLA on the CPU flushes subnormals to zero
    in comparisons (there 1e-45 > 0 is false)."""
    objs, valid = _special_pool(300, k, seed=40 + k, frac=0.8,
                                values=SUBNORMALS)
    t_objs, t_valid = torch.as_tensor(objs), torch.as_tensor(valid)
    np.testing.assert_array_equal(
        dominance_counts_bits_mirror(t_objs, t_valid).numpy(),
        dominance_counts_ref(t_objs, t_valid).numpy())
