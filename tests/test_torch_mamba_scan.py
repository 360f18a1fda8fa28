"""The port's Mamba-1 selective scan (``repro_torch.kernels.mamba_scan``)
against the JAX reference on the same numpy inputs: the wrapper's CPU path
(the plain sequential loop) against the reference's ``selective_scan_ref``
and its Pallas kernel in interpret mode, at the reference kernel test's
shapes with and without h0, plus the state-threading invariant.  The CUDA
kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.mamba_scan import selective_scan_pallas
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_ref
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

# tests/test_kernels.py MS_SHAPES: (B, S, Di, Ds, chunk)
MS_SHAPES = [(1, 16, 8, 4, 8), (2, 32, 16, 8, 8), (1, 64, 32, 16, 16)]
TOL = 1e-4      # the reference kernel test's: float32 sums in another order


def _inputs(B, S, Di, Ds, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=n(B, S, Di),
                delta=np.log1p(np.exp(n(B, S, Di))).astype(np.float32),
                A=(-np.exp(n(Di, Ds) * 0.3)).astype(np.float32),
                Bc=n(B, S, Ds), Cc=n(B, S, Ds), h0=n(B, Di, Ds))


@pytest.mark.parametrize("B,S,Di,Ds,chunk", MS_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_port_matches_reference_oracle_and_pallas_kernel(B, S, Di, Ds,
                                                         chunk, with_h0):
    x = _inputs(B, S, Di, Ds)
    if not with_h0:
        x["h0"] = None
    jx = {k: None if v is None else jnp.asarray(v) for k, v in x.items()}
    want = [np.asarray(a) for a in jax_ref(**jx)]
    pallas = [np.asarray(a) for a in selective_scan_pallas(
        **jx, chunk=chunk, interpret=True)]
    before = ops.selective_scan.launches
    y, hT = ops.selective_scan(**{k: None if v is None else torch.as_tensor(v)
                                  for k, v in x.items()})
    assert ops.selective_scan.launches == before     # CPU: plain version
    assert y.dtype == hT.dtype == torch.float32
    for ref in (want, pallas):
        np.testing.assert_allclose(y.numpy(), ref[0], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(hT.numpy(), ref[1], atol=TOL, rtol=TOL)


def test_two_calls_with_the_carried_state_equal_one():
    """Scanning [0:S] equals scanning [0:S/2] then [S/2:S] from the carried
    state — the decode-step invariant."""
    x = {k: torch.as_tensor(v) for k, v in _inputs(1, 32, 8, 4, 3).items()}
    y, h = selective_scan_ref(x["u"], x["delta"], x["A"], x["Bc"], x["Cc"])
    s = slice(0, 16), slice(16, 32)
    y1, h1 = ops.selective_scan(x["u"][:, s[0]], x["delta"][:, s[0]], x["A"],
                                x["Bc"][:, s[0]], x["Cc"][:, s[0]])
    ys = [y1]
    for t in range(16, 32):          # then one step at a time, as decode
        yt, h1 = ops.selective_scan(x["u"][:, t:t + 1],
                                    x["delta"][:, t:t + 1], x["A"],
                                    x["Bc"][:, t:t + 1], x["Cc"][:, t:t + 1],
                                    h0=h1)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(h1, h, atol=TOL, rtol=TOL)


def test_wrapper_checks_shapes_on_every_device():
    x = {k: torch.as_tensor(v) for k, v in _inputs(1, 8, 8, 4).items()}
    for key, bad in [("delta", x["delta"][:, :4]), ("A", x["A"][:, :2]),
                     ("Bc", x["Bc"][..., :2]), ("h0", x["h0"][0]),
                     ("u", x["u"][0])]:
        with pytest.raises(ValueError):
            ops.selective_scan(**(x | {key: bad}))
