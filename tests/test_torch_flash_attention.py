"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX reference on the same numpy inputs: the plain
``attention_ref`` and the wrapper's CPU path (``flash_attention_blocked``)
against the reference's oracle and against its Pallas kernel in interpret
mode, at the reference kernel test's shapes and at MLA's head dims (D 192,
Dv 128); then ragged lengths and fully masked rows on the port's side.  The CUDA kernel itself is held against
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ops import \
    flash_attention_blocked as jax_blocked
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, flash_attention_blocked, flash_attention_tc_mirror)

# tests/test_kernels.py FA_SHAPES: (B, Sq, Sk, H, KV, D, mask, window, kv_valid)
FA_SHAPES = [
    (1, 32, 32, 4, 4, 16, "causal", 0, None),
    (2, 64, 64, 8, 2, 32, "causal", 0, None),
    (1, 64, 64, 4, 1, 64, "window", 16, None),
    (2, 32, 32, 4, 2, 16, "none", 0, None),
    (2, 8, 64, 4, 2, 16, "causal", 0, 40),
    (1, 16, 48, 2, 2, 8, "none", 0, 33),
]
# float32: the reference kernel test's tolerance (sums of D products in
# another order); bfloat16: one bf16 rounding of the output
TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, H, KV, D, seed=0, Dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, Dv or D)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.as_tensor(x).to(dtype) for x in xs]


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
def test_port_matches_reference_oracle_and_pallas_kernel(shape):
    B, Sq, Sk, H, KV, D, mk, w, kvl = shape
    q, k, v = _inputs(B, Sq, Sk, H, KV, D)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), mk, w, kvl))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mk, w, kvl,
        block_q=8, block_k=16, interpret=True))
    tq, tk, tv = _t(q, k, v)
    before = ops.flash_attention.launches
    before_tc = ops.flash_attention.launches_tc
    for got in (attention_ref(tq, tk, tv, mk, w, kvl),
                flash_attention_blocked(tq, tk, tv, mk, w, kvl, block_k=16),
                ops.flash_attention(tq, tk, tv, mk, w, kvl)):
        for ref in (want, pallas):
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-5,
                                       rtol=2e-5)
    assert ops.flash_attention.launches == before   # CPU: plain version
    assert ops.flash_attention.launches_tc == before_tc


# MLA's head dims (DeepSeek-V2: q/k 128 nope + 64 rope = 192, v 128), causal
# and with a kv_valid_len past Sq (queries at 36..99, keys from 100 masked):
# (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid)
MLA_SHAPES = [(1, 64, 64, 4, 4, 192, 128, "causal", 0, None),
              (1, 64, 128, 4, 4, 192, 128, "causal", 0, 100)]


@pytest.mark.parametrize("shape", MLA_SHAPES, ids=str)
def test_port_matches_reference_at_mla_head_dims(shape):
    """D 192 over Dv 128 — what the reference's MLA hands its kernel — in
    float32: the port's plain versions and the wrapper's CPU path against
    the reference's oracle and its Pallas kernel in interpret mode."""
    B, Sq, Sk, H, KV, D, Dv, mk, w, kvl = shape
    q, k, v = _inputs(B, Sq, Sk, H, KV, D, seed=D + Sk, Dv=Dv)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), mk, w, kvl))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mk, w, kvl,
        block_q=8, block_k=16, interpret=True))
    assert want.shape == (B, Sq, H, Dv)
    tq, tk, tv = _t(q, k, v)
    for got in (attention_ref(tq, tk, tv, mk, w, kvl),
                flash_attention_blocked(tq, tk, tv, mk, w, kvl, block_k=16),
                ops.flash_attention(tq, tk, tv, mk, w, kvl)):
        for ref in (want, pallas):
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-5,
                                       rtol=2e-5)


@pytest.mark.parametrize("shape", MLA_SHAPES, ids=str)
def test_port_bf16_matches_reference_at_mla_head_dims(shape):
    """The same in bfloat16: the wrapper's CPU path and the tensor-core
    kernel's rounding (``flash_attention_tc_mirror``: P to bf16 before P V,
    the 1/sqrt(192) scale after the product) against the reference's
    oracle on the same bf16 inputs, within one bf16 rounding (2e-2)."""
    B, Sq, Sk, H, KV, D, Dv, mk, w, kvl = shape
    q, k, v = _inputs(B, Sq, Sk, H, KV, D, seed=D + Sk + 1, Dv=Dv)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax_ref(*jb, mk, w, kvl).astype(jnp.float32))
    tb = _t(q, k, v, dtype=torch.bfloat16)
    for got in (ops.flash_attention(*tb, mk, w, kvl),
                flash_attention_tc_mirror(*tb, mk, w, kvl)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


def test_wrapper_limits_are_mlas_head_dims():
    """D up to 192 and Dv up to 128 are the kernels' limits (a CUDA tensor
    past them raises, ``test_torch_cuda.py``); the shape checks that run
    on every device pass MLA's dims."""
    assert (ops.MAX_D, ops.MAX_DV) == (192, 128)
    q, k, v = _t(*_inputs(1, 8, 8, 2, 2, 192, Dv=128))
    assert ops.flash_attention(q, k, v).shape == (1, 8, 2, 128)


@pytest.mark.parametrize("shape", FA_SHAPES[:3], ids=str)
def test_port_bf16_matches_reference_oracle(shape):
    B, Sq, Sk, H, KV, D, mk, w, kvl = shape
    q, k, v = _inputs(B, Sq, Sk, H, KV, D, seed=1)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax_ref(*jb, mk, w, kvl).astype(jnp.float32))
    got = ops.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), mk, w,
                              kvl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


# the bf16 tensor-core kernel's rounding (P to bf16 before P V, the scale
# after the product, l from the float32 P) against the reference oracle in
# float32 on the same bf16-valued inputs, at a reduced serving-like shape
# (GQA 5:1, D 64, window 256): within the serving gate the card holds the
# kernel to (atol 4e-3, rtol 8e-3), so rounding P cannot break it.  The
# ragged case keeps Sq <= kv_valid_len: no row is fully masked (the oracle
# averages v over such a row, the online-softmax paths write 0)
@pytest.mark.parametrize("Sq,Sk,kvl", [(300, 300, None), (200, 300, 287)])
def test_tensor_core_rounding_holds_the_serving_gate(Sq, Sk, kvl):
    q, k, v = _t(*_inputs(1, Sq, Sk, 5, 1, 64, seed=Sq + Sk),
                 dtype=torch.bfloat16)
    want = np.asarray(jax_ref(*(jnp.asarray(x.float().numpy())
                                for x in (q, k, v)), "window", 256, kvl))
    got = flash_attention_tc_mirror(q, k, v, "window", 256, kvl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=4e-3,
                               rtol=8e-3)


@pytest.mark.parametrize("Sq,Sk,mk,w,kvl,bk", [
    (37, 37, "window", 16, None, 16),      # ragged, not a block multiple
    (1000, 1000, "window", 300, None, 512),
    (13, 53, "causal", 0, 41, 16),         # ragged kv_valid_len
    (5, 29, "none", 0, 29, 8),
])
def test_ragged_lengths_agree_with_the_oracle(Sq, Sk, mk, w, kvl, bk):
    q, k, v = _t(*_inputs(1, Sq, Sk, 4, 2, 16, seed=Sq + Sk))
    want = attention_ref(q, k, v, mk, w, kvl)
    got = flash_attention_blocked(q, k, v, mk, w, kvl, block_k=bk)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_fully_masked_rows_write_zero_like_the_reference_blocked_path():
    """Queries at negative positions see no key: the online-softmax paths
    (the reference's blocked scan, the port's, and so the kernel's) write
    0 there, guarded against NaN, and agree on the other rows."""
    q, k, v = _inputs(1, 6, 8, 2, 1, 16, seed=3, Dv=8)
    want = np.asarray(jax_blocked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), "causal", 0, 3,
                                  block_k=4))
    got = flash_attention_blocked(*_t(q, k, v), "causal", 0, 3,
                                  block_k=4).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (1, 6, 2, 8)
    np.testing.assert_array_equal(got[:, :3], 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_wrapper_checks_shapes_on_every_device():
    q, k, v = _t(*_inputs(1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                    # 3 heads over 2
    q, k, v = _t(*_inputs(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, "sliding")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, "causal", 0, 9)    # past Sk
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k, v)
