"""Plain PyTorch version of the Mamba-1 selective scan: the sequential
loop over time of ``repro/kernels/mamba_scan/ref.py``.  The CPU path of
``ops.selective_scan`` and the oracle the CUDA kernel is held against.

    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) B_t
    y_t = C_t . h_t

Shapes: u/delta (B, S, Di); A (Di, Ds); Bc/Cc (B, S, Ds); h (B, Di, Ds).
"""

from __future__ import annotations

import torch


def selective_scan_ref(u, delta, A, Bc, Cc, h0=None):
    """Returns (y (B, S, Di) float32, h_T (B, Di, Ds) float32)."""
    B, S, Di = u.shape
    Ds = A.shape[1]
    h = (torch.zeros((B, Di, Ds), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        d_t = delta[:, t]
        dA = torch.exp(d_t[..., None] * A[None])              # (B, Di, Ds)
        dBu = (d_t * u[:, t])[..., None] * Bc[:, t, None, :]  # (B, Di, Ds)
        h = dA * h + dBu
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, Di), dtype=torch.float32, device=u.device))
    return y, h
