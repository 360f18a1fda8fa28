"""Plain PyTorch version of the Matérn-5/2 covariance kernel: the direct
differences of ``repro/kernels/gp_cov/ref.py`` and
``repro.core.optimizer.matern52``, chunked over the rows of ``X1`` so a
4096 x 4096 x 62 product stays in a few hundred MB.  The CPU path of
``ops.matern52`` and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import math

import torch

SQRT5 = math.sqrt(5.0)


def matern52_ref(X1, X2, lengthscale: float = 0.3,
                 chunk_elems: int = 1 << 26):
    """X1: (n, d); X2: (m, d) -> K (n, m) float32, with
    r = sqrt(max(|x - z|^2, 1e-12)) / lengthscale and
    K = (1 + sqrt(5) r + 5 r^2 / 3) exp(-sqrt(5) r)."""
    n, m, d = X1.shape[0], X2.shape[0], X1.shape[1]
    rows = max(1, chunk_elems // max(m * d, 1))
    out = torch.empty((n, m), dtype=torch.float32, device=X1.device)
    for lo in range(0, n, rows):
        d2 = ((X1[lo:lo + rows, None, :] - X2[None, :, :]) ** 2).sum(-1)
        r = torch.sqrt(d2.clamp_min(1e-12)) / lengthscale
        out[lo:lo + rows] = ((1.0 + SQRT5 * r + 5.0 * r * r / 3.0)
                             * torch.exp(-SQRT5 * r))
    return out
