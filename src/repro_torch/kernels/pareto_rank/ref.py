"""Plain PyTorch version of the dominance-count kernel: the broadcast
(n, n, k) comparison of ``repro/kernels/pareto_rank/ref.py``, chunked over
the dominated rows so an 8192-row pool fits.  The CPU path of
``ops.dominance_counts`` and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch


def dominance_counts_ref(objs, valid, chunk: int = 1024):
    """``objs``: (n, k) objective rows (all minimized); ``valid``: (n,)
    rows allowed to dominate.  Returns (n,) int32: for each row, how many
    valid rows dominate it (<= on every objective, < on at least one)."""
    n = objs.shape[0]
    v = valid.to(torch.bool)[:, None]
    out = torch.empty(n, dtype=torch.int32, device=objs.device)
    for lo in range(0, n, chunk):
        oj = objs[None, lo:lo + chunk, :]                # dominated rows
        le = (objs[:, None, :] <= oj).all(-1)            # (n, c)
        lt = (objs[:, None, :] < oj).any(-1)
        out[lo:lo + chunk] = (le & lt & v).sum(0, dtype=torch.int32)
    return out
