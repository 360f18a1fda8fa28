"""The arithmetic of the port's float32 attention kernels on tensor cores,
on the CPU: the split of a float32 value into TF32 high and low parts
(``ref.split_tf32``), a product as three TF32 products of the parts
(``ref.matmul_tf32x3``, 3xTF32) against a float64 product, and the blocked
forward and backward with their matrix products run that way against the
plain versions and the JAX reference.  Three products hold the float32
tolerances (2e-5 forward, 3e-5 backward); one TF32 product misses them,
which is why the kernels (``csrc/flash_attention_tf32.cu``,
``csrc/flash_attention_bwd_tf32.cu``) take three.  The kernels themselves
are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, einsum_tf32, flash_attention_blocked,
    flash_attention_bwd_blocked, matmul_tf32x3, split_tf32)

# the small shapes of the card test's FA_SHAPES (tests/test_torch_cuda.py):
# (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid_len)
SHAPES = [
    (1, 32, 32, 4, 4, 16, 16, "causal", 0, None),
    (2, 64, 64, 8, 2, 32, 32, "causal", 0, None),
    (1, 64, 64, 4, 1, 64, 64, "window", 16, None),
    (2, 32, 32, 4, 2, 16, 16, "none", 0, None),
    (2, 8, 64, 4, 2, 16, 16, "causal", 0, 40),
    (1, 16, 48, 2, 2, 8, 8, "none", 0, 33),
    (1, 256, 256, 4, 2, 64, 32, "causal", 0, None),
    (2, 96, 160, 4, 1, 16, 64, "window", 48, 150),
    (1, 200, 200, 4, 2, 128, 128, "causal", 0, None),
    (1, 130, 190, 2, 1, 64, 128, "none", 0, None),
    (1, 64, 64, 4, 4, 192, 128, "causal", 0, None),
    (1, 64, 128, 4, 4, 192, 128, "causal", 0, 100),
    (1, 3, 300, 4, 2, 64, 64, "causal", 0, 290),
    (2, 77, 90, 4, 2, 36, 20, "causal", 0, None),
    (2, 1, 333, 8, 1, 37, 53, "window", 100, 300),
]
FWD_TOL = 2e-5      # the float32 forward's tolerance (atol and rtol)
BWD_TOL = 3e-5      # the float32 backward's (the reference's gradients)
# |a b - matmul_tf32x3(a, b)| over sum_k |a_ik| |b_kj|: each product is
# within 3 x 2^-22 of |a b| (two dropped roundings and lo lo), plus the
# float32 sums (about 2e-7 at K = 64..192, as a plain float32 product);
# one TF32 product is off by up to 2^-11 of each term (1.4e-4 to 2.5e-4
# here), more than 64 times the bound
MATMUL_BOUND = 2.0 ** -20


def _values(kind: str) -> torch.Tensor:
    """Random signs and mantissas at binary exponents around 0 (random),
    down to 2^-114 (tiny: the low part stays a normal float) and up to
    2^126 (huge); and zeros of both signs."""
    rng = np.random.default_rng(3)
    if kind == "zeros":
        return torch.tensor([0.0, -0.0, 0.0, -0.0])
    lo, hi = {"random": (-10, 10), "tiny": (-114, -90),
              "huge": (90, 126)}[kind]
    x = (rng.choice([-1.0, 1.0], 4096) * (1.0 + rng.random(4096))
         * 2.0 ** rng.integers(lo, hi, 4096))
    return torch.as_tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["random", "tiny", "huge", "zeros"])
def test_split_tf32_keeps_ten_mantissa_bits_and_sums_back_to_x(kind):
    x = _values(kind)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        # TF32: 10 of float32's 23 mantissa bits, the 13 low bits zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # hi is x rounded to the nearest TF32: within half a TF32 unit
    assert bool(((x.double() - hi.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())
    assert torch.equal(torch.signbit(hi), torch.signbit(x))


@pytest.mark.parametrize("K", [64, 128, 192])
def test_matmul_tf32x3_against_float64(K):
    rng = np.random.default_rng(K)
    a = torch.as_tensor(rng.standard_normal((64, K)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((K, 64)), dtype=torch.float32)
    want = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    three = ((matmul_tf32x3(a, b).double() - want).abs() / mag).max()
    one = ((matmul_tf32x3(a, b, products=1).double() - want).abs()
           / mag).max()
    assert float(three) <= MATMUL_BOUND
    assert float(one) > 64 * MATMUL_BOUND
    # the same product through einsum_tf32's batch form
    assert torch.equal(einsum_tf32("ik,kj->ij", a, b), matmul_tf32x3(a, b))


def _inputs(shape, seed):
    B, Sq, Sk, H, KV, D, Dv, mk, w, kvl = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, Dv)).astype(np.float32),
            rng.standard_normal((B, Sq, H, Dv)).astype(np.float32))


def _fwd_err(shape, products):
    """Max of |mirror - want| / (atol + rtol |want|) against the port's and
    the JAX reference's attention: <= 1 is within the tolerance."""
    B, Sq, Sk, H, KV, D, Dv, mk, w, kvl = shape
    q, k, v, _ = _inputs(shape, sum(shape[:7]))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    got = flash_attention_blocked(tq, tk, tv, mk, w, kvl, products=products)
    worst = 0.0
    for want in (attention_ref(tq, tk, tv, mk, w, kvl),
                 torch.as_tensor(np.array(jax_ref(
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mk, w,
                     kvl)))):
        ratio = (got - want).abs() / (FWD_TOL + FWD_TOL * want.abs())
        worst = max(worst, float(ratio.max()))
    return worst


def _bwd_err(shape, products):
    """Max of |mirror - plain| / (atol + rtol |plain|) over dq, dk, dv."""
    B, Sq, Sk, H, KV, D, Dv, mk, w, kvl = shape
    q, k, v, dout = (torch.as_tensor(x)
                     for x in _inputs(shape, 7 + sum(shape[:7])))
    out, lse = flash_attention_blocked(q, k, v, mk, w, kvl, return_lse=True)
    want = flash_attention_bwd_blocked(q, k, v, out, lse, dout, mk, w, kvl)
    got = flash_attention_bwd_blocked(q, k, v, out, lse, dout, mk, w, kvl,
                                      products=products)
    return max(float(((g - r).abs() / (BWD_TOL + BWD_TOL * r.abs())).max())
               for g, r in zip(got, want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_with_3xtf32_products_holds_the_float32_tolerance(shape):
    assert _fwd_err(shape, 3) <= 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_with_3xtf32_products_holds_the_float32_tolerance(shape):
    assert _bwd_err(shape, 3) <= 1.0


def test_one_tf32_product_misses_the_float32_tolerances():
    """The same mirrors with one TF32 product a product: outside the
    forward's 2e-5 and the backward's 3e-5 at (at least) some shapes."""
    fwd = [_fwd_err(s, 1) for s in SHAPES]
    bwd = [_bwd_err(s, 1) for s in SHAPES]
    assert max(fwd) > 1.0 and max(bwd) > 1.0


def test_tf32_probe_rejects_what_it_does_not_take():
    """``ops.tf32_probe`` measures the card's products only: CPU tensors,
    other head dims and mismatched shapes raise before any launch."""
    from repro_torch.kernels.flash_attention import ops
    a = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="one card"):
        ops.tf32_probe(a, a)
    for bad in (torch.zeros(64, 48), torch.zeros(32, 64)):
        with pytest.raises(ValueError, match="must be"):
            ops.tf32_probe(bad, bad)
    with pytest.raises(ValueError, match="must be"):
        ops.tf32_probe(a, torch.zeros(64, 128))
