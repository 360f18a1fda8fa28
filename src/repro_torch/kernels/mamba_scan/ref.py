"""Plain PyTorch versions of the Mamba-1 selective scan and its gradient:
the sequential loop over time of ``repro/kernels/mamba_scan/ref.py``, and
its reverse-time backward (the gradient the reference takes by autodiff of
``selective_scan_assoc``).  The CPU paths of ``ops.selective_scan`` and
``ops.selective_scan_bwd`` and the oracles the CUDA kernels are held
against.

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


def selective_scan_bwd_ref(u, delta, A, Bc, Cc, h0, dy, dhT=None):
    """Gradients (du, ddelta, dA, dB, dC, dh0) of (y, h_T) =
    ``selective_scan_ref(u, delta, A, Bc, Cc, h0)`` for the gradients
    ``dy`` (B, S, Di) of y and ``dhT`` (B, Di, Ds) of h_T (None: zeros);
    dh0 is None without h0.  With a_t = exp(delta_t A) and g_t the
    gradient of h_t:

        g_t = C_t dy_t + a_{t+1} g_{t+1}        (g_{S-1} adds dhT)
        du_t = delta_t sum_n g_t B_t,  ddelta_t = sum_n g_t (h_{t-1} a_t A
        + u_t B_t),  dA = sum_{b,t} g_t h_{t-1} a_t delta_t,
        dB_t = sum_di g_t delta_t u_t,  dC_t = sum_di dy_t h_t,
        dh0 = a_0 g_0."""
    B, S, Di = u.shape
    Ds = A.shape[1]
    dev = u.device
    h = (torch.zeros((B, Di, Ds), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    hs = [h]                                   # h_{-1}, h_0, ..., h_{S-1}
    for t in range(S):
        d_t = delta[:, t]
        h = (torch.exp(d_t[..., None] * A[None]) * h
             + (d_t * u[:, t])[..., None] * Bc[:, t, None, :])
        hs.append(h)
    g = (torch.zeros((B, Di, Ds), dtype=torch.float32, device=dev)
         if dhT is None else dhT.float())
    du = torch.empty((B, S, Di), dtype=torch.float32, device=dev)
    ddelta = torch.empty_like(du)
    dB = torch.empty((B, S, Ds), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    # dA sums B * S terms: accumulated in float64, so this oracle's own
    # rounding stays far below the kernel's tolerance
    dA = torch.zeros((Di, Ds), dtype=torch.float64, device=dev)
    for t in range(S - 1, -1, -1):
        d_t, u_t, b_t = delta[:, t], u[:, t], Bc[:, t, None, :]
        a_t = torch.exp(d_t[..., None] * A[None])
        gt = g + Cc[:, t, None, :] * dy[:, t, :, None]
        gha = gt * hs[t] * a_t
        gb = (gt * b_t).sum(-1)
        ddelta[:, t] = (gha * A[None]).sum(-1) + gb * u_t
        du[:, t] = gb * d_t
        dA += (gha * d_t[..., None]).double().sum(0)
        dB[:, t] = torch.einsum("bds,bd->bs", gt, d_t * u_t)
        dC[:, t] = torch.einsum("bd,bds->bs", dy[:, t], hs[t + 1])
        g = a_t * gt
    return du, ddelta, dA.float(), dB, dC, (None if h0 is None else g)
