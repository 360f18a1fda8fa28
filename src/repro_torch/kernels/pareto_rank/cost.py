"""The work of one dominance count, from its shape: the formula that both
``chip_smoke.py``'s bound and ``launch.graph_analysis`` read.

A pool of n rows of k float32 objectives (and n validity bytes) is read
once and n int32 counts are written once; every (dominating, dominated)
pair takes 2k FP32 comparisons (<= and < on each objective).  Lanes
multiply both."""

from __future__ import annotations


def dominance_work(n: int, k: int, lanes: int = 1) -> tuple:
    """(FP32 operations, bytes) of one launch over ``lanes`` pools of (n,
    k)."""
    return lanes * n * n * 2 * k, lanes * (n * (4 * k + 1) + 4 * n)


def op_work(objs, valid) -> dict:
    """The work of one ``repro_torch::dominance_counts`` call on these
    arguments (tensors or fakes: shapes only)."""
    *lead, n, k = objs.shape
    ops, nbytes = dominance_work(n, k, lead[0] if lead else 1)
    return dict(flops=ops, bytes=nbytes, launches=1)
