"""The work of one Matérn-5/2 covariance, from its shape: the formula that
both ``chip_smoke.py``'s bound and ``launch.graph_analysis`` read.

X1 (n, d) and X2 (m, d) float32 are read once and K (n, m) is written
once; each of the n m entries takes 3 d FP32 operations for the squared
distance and 15 for the square root, the exponential and the
polynomial."""

from __future__ import annotations


def matern_work(n: int, m: int, d: int) -> tuple:
    """(FP32 operations, bytes) of one launch."""
    return n * m * (3 * d + 15), 4 * (n + m) * d + 4 * n * m


def op_work(X1, X2, lengthscale) -> dict:
    """The work of one ``repro_torch::matern52`` call on these arguments
    (tensors or fakes: shapes only)."""
    ops, nbytes = matern_work(X1.shape[0], X2.shape[0], X1.shape[1])
    return dict(flops=ops, bytes=nbytes, launches=1)
