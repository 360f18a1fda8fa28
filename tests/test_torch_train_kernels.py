"""The gradients of the port's two kernel ops on the CPU, against JAX's
gradients of the reference:

* attention: ``ops.flash_attention`` under autograd (``FlashAttentionFn``,
  whose CPU backward is ``ref.flash_attention_bwd_blocked``) against
  ``jax.grad`` of the reference's custom VJP ``_fa_diff`` — at the sizes of
  the reference's own gradient test (``tests/test_kernels.py``) and with a
  window, mask ``none``, GQA, D != Dv and a static ``kv_valid_len`` — at
  atol/rtol 3e-5, that test's tolerance; the forward's log-sum-exp against
  ``_fwd_with_lse``'s;
* the bf16 tensor-core backward's mirror (``ref.flash_attention_bwd_tc_mirror``):
  on float32 inputs equal to the plain backward within 3e-5, on bf16
  inputs against ``jax.grad`` of ``_fa_diff`` within bounds stated from
  bf16's unit roundoff (GQA, every mask, ``kv_valid_len``, head dims 16 to
  192 with Dv != D);
* the scan: ``ops.selective_scan`` under autograd (``SelectiveScanFn``,
  whose CPU backward is ``ref.selective_scan_bwd_ref`` from the forward's
  chunk states) against ``jax.grad`` of ``selective_scan_assoc``, with and
  without h0 and with a gradient on h_T, at 1e-4, the reference scan
  tests' tolerance; the chunk states against the plain loop's states.

Inputs are drawn with numpy and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import _fa_diff, _fwd_with_lse
from repro.kernels.mamba_scan.ops import selective_scan_assoc
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref

FA_TOL = dict(atol=3e-5, rtol=3e-5)
MS_TOL = dict(atol=1e-4, rtol=1e-4)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(fn, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


# the reference's test_flash_vjp_matches_autodiff_of_ref sizes: q (1, sq, 4,
# 16), k / v (1, sk, 2, 16), causal, block 16
@pytest.mark.parametrize("sq,sk", [(8, 16), (8, 48), (24, 16), (24, 48),
                                   (40, 16), (40, 48)])
def test_attention_grad_matches_the_reference_vjp(sq, sk):
    q, k, v = _draw(sq * 100 + sk, (1, sq, 4, 16), (1, sk, 2, 16),
                    (1, sk, 2, 16))
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
        _fa_diff(q, k, v, "causal", 0, None, 16))), argnums=(0, 1, 2))(
        q, k, v)
    got = _torch_grads(lambda q, k, v: torch.sin(
        fa_ops.flash_attention(q, k, v, "causal")).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **FA_TOL)


# (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid_len)
FA_CASES = [(2, 24, 24, 4, 2, 16, 16, "window", 8, None),
            (1, 33, 33, 4, 1, 16, 16, "window", 5, None),
            (2, 16, 40, 4, 2, 16, 16, "none", 0, None),
            (1, 20, 20, 6, 2, 16, 16, "causal", 0, None),
            (2, 32, 32, 4, 4, 24, 16, "causal", 0, None),
            (1, 16, 16, 4, 2, 8, 32, "none", 0, None),
            (2, 8, 48, 4, 2, 16, 16, "causal", 0, 40),
            (1, 6, 30, 4, 2, 16, 8, "window", 4, 29),
            (1, 16, 48, 2, 2, 8, 8, "none", 0, 33)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,Dv,mask,window,kvl", FA_CASES)
def test_attention_grad_masks_gqa_head_dims_and_valid_len(B, Sq, Sk, H, KV,
                                                          D, Dv, mask,
                                                          window, kvl):
    q, k, v, w = _draw(B * 1000 + Sq + Sk, (B, Sq, H, D), (B, Sk, KV, D),
                       (B, Sk, KV, Dv), (B, Sq, H, Dv))
    want = jax.grad(lambda q, k, v: jnp.sum(
        _fa_diff(q, k, v, mask, window, kvl, 16) * w), argnums=(0, 1, 2))(
        q, k, v)
    wt = torch.tensor(w)
    got = _torch_grads(lambda q, k, v: (fa_ops.flash_attention(
        q, k, v, mask, window, kvl) * wt).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **FA_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,Dv,mask,window,kvl", FA_CASES[:4]
                         + FA_CASES[6:8])
def test_forward_lse_matches_the_reference(B, Sq, Sk, H, KV, D, Dv, mask,
                                           window, kvl):
    q, k, v = _draw(7, (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv))
    out_j, lse_j, _, _ = _fwd_with_lse(q, k, v, mask, window, kvl, 16)
    out, lse = fa_ops.flash_attention_fwd_lse(*map(torch.tensor, (q, k, v)),
                                              mask, window, kvl)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FA_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **FA_TOL)


def test_fully_masked_rows_have_zero_gradients():
    """A query that sees no key (kv_valid_len 0 under ``none``) gets a zero
    output, a -FLT_MAX log-sum-exp and zero gradients, as the reference."""
    q, k, v = _draw(3, (1, 4, 2, 8), (1, 6, 2, 8), (1, 6, 2, 8))
    out, lse = fa_ops.flash_attention_fwd_lse(*map(torch.tensor, (q, k, v)),
                                              "none", 0, 0)
    assert float(out.abs().max()) == 0.0
    assert bool((lse == fa_ref.NEG_INF).all())
    got = _torch_grads(lambda q, k, v: fa_ops.flash_attention(
        q, k, v, "none", 0, 0).sum(), (q, k, v))
    assert all(float(np.abs(g).max()) == 0.0 for g in got)


def test_autograd_only_when_recording():
    """Serving (no grad, or no input requiring one) keeps the plain forward:
    no autograd node, nothing saved; training goes through
    ``FlashAttentionFn`` with the same output bits."""
    q, k, v = map(torch.tensor, _draw(4, (1, 8, 2, 8), (1, 8, 2, 8),
                                      (1, 8, 2, 8)))
    plain = fa_ops.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert fa_ops.flash_attention(qg, k, v).grad_fn is None
    out = fa_ops.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(out.detach(), plain)


def test_bwd_wrapper_checks_shapes():
    q, k, v = map(torch.tensor, _draw(5, (1, 8, 2, 8), (1, 8, 2, 8),
                                      (1, 8, 2, 8)))
    out, lse = fa_ops.flash_attention_fwd_lse(q, k, v)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, out, lse[:, :, :4], out)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, out, lse, out[:, :4])


# the bf16 tensor-core backward's mirror: (B, Sq, Sk, H, KV, D, Dv, mask,
# window, kv_valid_len) -- GQA, every mask, kv_valid_len, and the head-dim
# classes 16 / 32 (zero-padded to 64), 64, 128 and MLA's 192 / 128, with
# Dv != D
TC_CASES = FA_CASES + [(1, 24, 24, 4, 2, 32, 32, "causal", 0, None),
                       (1, 20, 36, 4, 4, 64, 64, "window", 12, 30),
                       (1, 16, 16, 4, 2, 128, 128, "causal", 0, None),
                       (1, 16, 24, 2, 2, 192, 128, "none", 0, 20),
                       (1, 16, 16, 4, 1, 16, 64, "causal", 0, None)]


def _bf16_values(*arrays):
    """The arrays rounded to bfloat16 values, kept as float32."""
    return [torch.tensor(a).to(torch.bfloat16).float().numpy()
            for a in arrays]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,Dv,mask,window,kvl", TC_CASES)
def test_bwd_tc_mirror_equals_the_plain_backward_in_float32(
        B, Sq, Sk, H, KV, D, Dv, mask, window, kvl):
    """On float32 inputs the mirror rounds nothing but float32 arithmetic,
    so it equals the plain backward within the float32 tolerance."""
    q, k, v, do = map(torch.tensor, _draw(B + Sq * 7 + D, (B, Sq, H, D),
                                          (B, Sk, KV, D), (B, Sk, KV, Dv),
                                          (B, Sq, H, Dv)))
    out, lse = fa_ops.flash_attention_fwd_lse(q, k, v, mask, window, kvl)
    want = fa_ref.flash_attention_bwd_blocked(q, k, v, out, lse, do, mask,
                                              window, kvl)
    got = fa_ref.flash_attention_bwd_tc_mirror(q, k, v, out, lse, do, mask,
                                               window, kvl)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FA_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,Dv,mask,window,kvl", TC_CASES)
def test_bwd_tc_mirror_matches_the_reference_vjp_in_bf16(
        B, Sq, Sk, H, KV, D, Dv, mask, window, kvl):
    """bf16 inputs: the mirror against ``jax.grad`` of ``_fa_diff`` on the
    same (bf16-valued) numbers in float32.  The mirror rounds each P and dS
    to bf16 before the product it feeds, an error of at most the unit
    roundoff u = 2^-8 of each term, and each gradient once at the end, at
    most u of it; so each gradient lies within u (terms + |gradient|) of
    the float32 one, terms the sum of the magnitudes of its rounded terms
    (the mirror's ``with_terms``), plus 1e-5 of the largest term sum for
    the float32 arithmetic of both."""
    q, k, v, w = _bf16_values(*_draw(B + Sq * 11 + D, (B, Sq, H, D),
                                     (B, Sk, KV, D), (B, Sk, KV, Dv),
                                     (B, Sq, H, Dv)))
    want = jax.grad(lambda q, k, v: jnp.sum(
        _fa_diff(q, k, v, mask, window, kvl, 16) * w), argnums=(0, 1, 2))(
        q, k, v)
    out, lse = fa_ops.flash_attention_fwd_lse(*map(torch.tensor, (q, k, v)),
                                              mask, window, kvl)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)
    got, terms = fa_ref.flash_attention_bwd_tc_mirror(
        bf(q), bf(k), bf(v), out, lse, bf(w), mask, window, kvl,
        with_terms=True)
    u = 2.0 ** -8
    for name, a, b, t in zip(("dq", "dk", "dv"), got, want, terms):
        b, t = np.asarray(b), t.numpy()
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - b)
        bound = u * (t + np.abs(b)) + 1e-5 * t.max()
        assert (err <= bound).all(), (name, float(err.max()))


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------
def _scan_inputs(B, S, Di, Ds, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = r(B, S, Di)
    dl = np.log1p(np.exp(r(B, S, Di))).astype(np.float32)
    A = (-np.exp(r(Di, Ds) * 0.3)).astype(np.float32)
    return u, dl, A, r(B, S, Ds), r(B, S, Ds), r(B, Di, Ds), r(B, S, Di), \
        r(B, Di, Ds)


# the reference kernel test's MS_SHAPES (B, S, Di, Ds) and a ragged one
MS_SHAPES = [(1, 16, 8, 4), (2, 32, 16, 8), (1, 64, 32, 16), (2, 37, 10, 3)]


@pytest.mark.parametrize("B,S,Di,Ds", MS_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("grad_hT", [False, True])
def test_scan_grad_matches_autodiff_of_the_reference(B, S, Di, Ds, with_h0,
                                                     grad_hT):
    u, dl, A, Bc, Cc, h0, gy, gh = _scan_inputs(B, S, Di, Ds, S + Di)
    wh = gh if grad_hT else np.zeros_like(gh)

    def jloss(u, dl, A, Bc, Cc, h0):
        y, hT = selective_scan_assoc(u, dl, A, Bc, Cc,
                                     h0 if with_h0 else None)
        return jnp.sum(y * gy) + jnp.sum(hT * wh)

    argnums = (0, 1, 2, 3, 4, 5) if with_h0 else (0, 1, 2, 3, 4)
    want = jax.grad(jloss, argnums=argnums)(u, dl, A, Bc, Cc, h0)
    gyt, wht = torch.tensor(gy), torch.tensor(wh)

    def tloss(u, dl, A, Bc, Cc, h0=None):
        y, hT = ms_ops.selective_scan(u, dl, A, Bc, Cc, h0)
        return (y * gyt).sum() + (hT * wht).sum()

    arrays = (u, dl, A, Bc, Cc) + ((h0,) if with_h0 else ())
    got = _torch_grads(tloss, arrays)
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dh0"), got,
                          want):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **MS_TOL)


def test_scan_bwd_without_dhT_equals_zero_dhT():
    u, dl, A, Bc, Cc, h0, gy, _ = map(torch.tensor,
                                      _scan_inputs(2, 9, 6, 4, 11))
    a = ms_ops.selective_scan_bwd(u, dl, A, Bc, Cc, h0, gy)
    b = ms_ops.selective_scan_bwd(u, dl, A, Bc, Cc, h0, gy,
                                  torch.zeros_like(h0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ms_ops.selective_scan_bwd(u, dl, A, Bc, Cc, None, gy)[5] is None


def test_scan_autograd_only_when_recording():
    u, dl, A, Bc, Cc, *_ = map(torch.tensor, _scan_inputs(1, 5, 4, 2, 12))
    y, hT = ms_ops.selective_scan(u, dl, A, Bc, Cc)
    assert y.grad_fn is None and hT.grad_fn is None
    y2, _ = ms_ops.selective_scan(u.clone().requires_grad_(), dl, A, Bc, Cc)
    assert type(y2.grad_fn).__name__ == "SelectiveScanFnBackward"
    assert torch.equal(y2.detach(), y)


def test_scan_bwd_ref_matches_autograd_of_the_plain_loop():
    """The reverse-time backward against autograd through the plain
    forward loop (both in PyTorch)."""
    arrays = _scan_inputs(2, 13, 7, 5, 13)
    u, dl, A, Bc, Cc, h0, gy, gh = map(torch.tensor, arrays)
    got = ms_ref.selective_scan_bwd_ref(u, dl, A, Bc, Cc, h0, gy, gh)
    leaves = [t.clone().requires_grad_() for t in (u, dl, A, Bc, Cc, h0)]
    y, hT = ms_ref.selective_scan_ref(*leaves)
    ((y * gy).sum() + (hT * gh).sum()).backward()
    for a, t in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("B,S,Di,Ds", [(2, 40, 6, 4), (1, 16, 5, 3),
                                       (1, 33, 4, 16)])
def test_scan_chunk_states_are_the_plain_loops_states(B, S, Di, Ds):
    """The plain forward's chunk states: chunk c's is h after c * 16 steps
    of the same loop, bit for bit (h0 for chunk 0)."""
    u, dl, A, Bc, Cc, h0, _, _ = map(torch.tensor,
                                     _scan_inputs(B, S, Di, Ds, S + Ds))
    y, hT, states = ms_ref.selective_scan_ref(u, dl, A, Bc, Cc, h0,
                                              return_states=True)
    assert states.shape == (B, ms_ref.n_state_chunks(S), Di, Ds)
    y0, hT0 = ms_ref.selective_scan_ref(u, dl, A, Bc, Cc, h0)
    assert torch.equal(y, y0) and torch.equal(hT, hT0)
    for c in range(states.shape[1]):
        t = c * ms_ref.STATE_CHUNK
        _, h = ms_ref.selective_scan_ref(u[:, :t], dl[:, :t], A, Bc[:, :t],
                                         Cc[:, :t], h0)
        assert torch.equal(states[:, c], h)
    _, _, st = ms_ops.selective_scan_fwd_states(u, dl, A, Bc, Cc, h0)
    assert torch.equal(st, states)


@pytest.mark.parametrize("B,S,Di,Ds", [(2, 40, 6, 4), (1, 33, 8, 16),
                                       (2, 17, 5, 3)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_bwd_from_saved_states_matches_autodiff(B, S, Di, Ds, with_h0):
    """The backward from the forward's chunk states (several chunks, the
    last ragged) against ``jax.grad`` of ``selective_scan_assoc`` at 1e-4,
    and equal to the backward that recomputes every state from h0."""
    u, dl, A, Bc, Cc, h0, gy, gh = _scan_inputs(B, S, Di, Ds, 3 * S + Ds)
    h0 = h0 if with_h0 else None

    def jloss(u, dl, A, Bc, Cc, h0):
        y, hT = selective_scan_assoc(u, dl, A, Bc, Cc, h0)
        return jnp.sum(y * gy) + jnp.sum(hT * gh)

    argnums = (0, 1, 2, 3, 4, 5) if with_h0 else (0, 1, 2, 3, 4)
    want = jax.grad(jloss, argnums=argnums)(u, dl, A, Bc, Cc, h0)
    ts = [None if a is None else torch.tensor(a)
          for a in (u, dl, A, Bc, Cc, h0)]
    _, _, states = ms_ref.selective_scan_ref(*ts, return_states=True)
    got = ms_ops.selective_scan_bwd(*ts, torch.tensor(gy), torch.tensor(gh),
                                    states)
    plain = ms_ref.selective_scan_bwd_ref(*ts, torch.tensor(gy),
                                          torch.tensor(gh))
    for name, a, b, c in zip(("du", "ddelta", "dA", "dB", "dC", "dh0"), got,
                             want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **MS_TOL)
        assert torch.equal(a, c), name
