"""The work of one selective scan forward or backward, from its shape: the
formulas that both ``chip_smoke.py``'s bounds and
``launch.graph_analysis`` read.

Forward: u, delta, A, Bc, Cc (and h0) float32 read once and y, h_T (and,
for training, the state at the start of every chunk of ``STATE_CHUNK``
steps) written once; 6 FP32 operations a (b, t, di, n): delta A, its
exponential, the update FMA (2), the output FMA (2).  Backward: u, delta,
dy, A, Bc, Cc (h0, dhT) read once and du, ddelta, dA, dB, dC (dh0)
written once; 10 FP32 operations a (b, t, di, n), and one exponential
exp(delta A) a (b, t, di, n) on the special-function units."""

from __future__ import annotations

from .ref import n_state_chunks

BWD_LAUNCHES = 2     # the reverse-time scan, the sums of its partials


def forward_work(B, S, Di, Ds, with_h0: bool, states: bool = False) -> tuple:
    """(FP32 operations, bytes) of one forward launch."""
    elems = (3 * B * S * Di + Di * Ds + 2 * B * S * Ds
             + B * Di * Ds * (2 if with_h0 else 1))
    if states:
        elems += B * n_state_chunks(S) * Di * Ds
    return 6 * B * S * Di * Ds, 4 * elems


def backward_work(B, S, Di, Ds, with_h0: bool) -> tuple:
    """(FP32 operations, bytes) of one backward call (its two launches)."""
    elems = (5 * B * S * Di + 2 * Di * Ds + 4 * B * S * Ds
             + (3 * B * Di * Ds if with_h0 else 0))
    return 10 * B * S * Di * Ds, 4 * elems


def exponentials(B, S, Di, Ds) -> int:
    """The exponentials exp(delta A) a backward needs: one a (b, t, di,
    n)."""
    return B * S * Di * Ds


def _dims(u, A):
    B, S, Di = u.shape
    return B, S, Di, A.shape[1]


def fwd_op_work(u, delta, A, Bc, Cc, h0) -> dict:
    """The work of one ``repro_torch::selective_scan`` call (tensors or
    fakes: shapes only)."""
    ops, nbytes = forward_work(*_dims(u, A), h0 is not None)
    return dict(flops=ops, bytes=nbytes, launches=1)


def fwd_states_op_work(u, delta, A, Bc, Cc, h0) -> dict:
    """... of one ``repro_torch::selective_scan_fwd_states`` call."""
    ops, nbytes = forward_work(*_dims(u, A), h0 is not None, states=True)
    return dict(flops=ops, bytes=nbytes, launches=1)


def bwd_op_work(u, delta, A, Bc, Cc, h0, dy, dhT, states) -> dict:
    """... of one ``repro_torch::selective_scan_bwd`` call: without the
    forward's states it runs the forward for them first (one more launch
    and its work)."""
    dims = _dims(u, A)
    ops, nbytes = backward_work(*dims, h0 is not None)
    launches = BWD_LAUNCHES
    if states is None:
        f_ops, f_bytes = forward_work(*dims, h0 is not None, states=True)
        ops, nbytes, launches = ops + f_ops, nbytes + f_bytes, launches + 1
    return dict(flops=ops, bytes=nbytes, launches=launches)
