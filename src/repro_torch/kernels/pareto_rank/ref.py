"""Plain PyTorch versions of the dominance-count kernel.

* ``dominance_counts_ref`` — the broadcast (n, n, k) comparison of
  ``repro/kernels/pareto_rank/ref.py``, chunked over the dominated rows so
  an 8192-row pool fits.  The CPU path of ``ops.dominance_counts`` and the
  oracle the CUDA kernel is held against.
* ``dominance_counts_bits_mirror`` — the CUDA kernel's arithmetic on
  finite tiles (``csrc/pareto_rank.cu``), for tests: the bit patterns of
  the float32 differences o_j - o_i ORed together, a pair counted when the
  result is positive as a signed integer.  Never on the main path.
"""

from __future__ import annotations

import torch


def dominance_counts_ref(objs, valid, chunk: int = 1024):
    """``objs``: (n, k) objective rows (all minimized); ``valid``: (n,)
    rows allowed to dominate.  Returns (n,) int32: for each row, how many
    valid rows dominate it (<= on every objective, < on at least one).
    A leading lane axis, (L, n, k) and (L, n), ranks each lane on its own
    and returns (L, n)."""
    if objs.dim() == 3:
        return torch.stack([dominance_counts_ref(o, v, chunk)
                            for o, v in zip(objs, valid)]) if len(objs) \
            else torch.empty(objs.shape[:2], dtype=torch.int32,
                             device=objs.device)
    n = objs.shape[0]
    v = valid.to(torch.bool)[:, None]
    out = torch.empty(n, dtype=torch.int32, device=objs.device)
    for lo in range(0, n, chunk):
        oj = objs[None, lo:lo + chunk, :]                # dominated rows
        le = (objs[:, None, :] <= oj).all(-1)            # (n, c)
        lt = (objs[:, None, :] < oj).any(-1)
        out[lo:lo + chunk] = (le & lt & v).sum(0, dtype=torch.int32)
    return out


def dominance_counts_bits_mirror(objs, valid):
    """The kernel's finite-tile arithmetic for a pool of finite float32
    rows: values staged as x + 0 (no -0), invalid dominators as +inf, and
    i dominates j when OR_c bits(o_j,c - o_i,c) > 0 as int32.  Equal to
    ``dominance_counts_ref`` on every finite pool; (n,) int32."""
    o = objs.to(torch.float32) + 0.0
    oi = torch.where(valid.to(torch.bool)[:, None], o,
                     torch.full_like(o, float("inf")))
    d = (o[None, :, :] - oi[:, None, :]).view(torch.int32)   # (i, j, k)
    u = d[..., 0]
    for c in range(1, d.shape[-1]):
        u = u | d[..., c]
    return (u > 0).sum(0, dtype=torch.int32)
