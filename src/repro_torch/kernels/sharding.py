"""DTensor sharding rules of the LM kernel operators, so that a model whose
parameters are DTensors reaches the kernels: each rule lists, for one mesh
dimension, the layouts under which the operator runs on every rank's
local shard as it is and gives the local share of the global result.
DTensor expands them over the mesh (dropping a layout whose dims do not
divide), and redistributes any other input layout to the cheapest of them
before the call; the call itself is the operator's own (its CUDA kernel on
a card shard, which raises where the kernel cannot run: no fallback).

* ``flash_attention`` (forward, forward with LSE, backward): the batch
  dim, or the head dim of q, k, v and the output alike (each rank then
  holds whole GQA groups: H / n query heads over KV / n key heads);
  sequence and head width replicated.
* ``selective_scan`` (forward, forward with states, backward): the batch
  dim, or the channel dim Di (A's rows with it; B and C replicated);
  time replicated.  The backward's sums over a sharded dim (dA over the
  batch, dB and dC over the channels) are ``Partial``.

``pareto_rank`` and ``gp_cov`` take no rule: the island engine calls them
on plain tensors.  ``register()`` installs the rules (once)."""

from __future__ import annotations

import functools


def _fa_fwd(q, k, v, mask_kind, window, kv_valid_len, *, lse: bool):
    from torch.distributed.tensor import Replicate, Shard
    R, none = Replicate(), [None] * 3
    return [([R, R] if lse else [R], [R] * 3 + none),
            ([Shard(0), Shard(0)] if lse else [Shard(0)],
             [Shard(0)] * 3 + none),
            ([Shard(2), Shard(1)] if lse else [Shard(2)],
             [Shard(2)] * 3 + none)]


def _fa_bwd(q, k, v, out, lse, dout, mask_kind, window, kv_valid_len):
    from torch.distributed.tensor import Replicate, Shard
    R, none = Replicate(), [None] * 3
    return [([R] * 3, [R] * 6 + none),
            ([Shard(0)] * 3, [Shard(0)] * 6 + none),
            ([Shard(2)] * 3, [Shard(2)] * 4 + [Shard(1), Shard(2)] + none)]


def _scan_fwd(u, delta, A, Bc, Cc, h0, *, states: bool):
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()

    def h(p):                   # h0 is optional
        return None if h0 is None else p
    return [([R] * (3 if states else 2), [R] * 5 + [h(R)]),
            ([Shard(0)] * (3 if states else 2),
             [Shard(0), Shard(0), R, Shard(0), Shard(0), h(Shard(0))]),
            ([Shard(2), Shard(1)] + ([Shard(2)] if states else []),
             [Shard(2), Shard(2), Shard(0), R, R, h(Shard(1))])]


def _scan_bwd(u, delta, A, Bc, Cc, h0, dy, dhT, states):
    from torch.distributed.tensor import Partial, Replicate, Shard
    R = Replicate()

    def h(p):
        return None if h0 is None else p

    def st(p):
        return None if states is None else p
    # outputs du, ddelta, dA, dB, dC, dh0 (an empty (0,) without h0);
    # inputs u, delta, A, Bc, Cc, h0, dy, dhT, states
    return [([R] * 6, [R] * 5 + [h(R), R, R, st(R)]),
            ([Shard(0), Shard(0), Partial(), Shard(0), Shard(0),
              h(Shard(0)) or R],
             [Shard(0), Shard(0), R, Shard(0), Shard(0), h(Shard(0)),
              Shard(0), Shard(0), st(Shard(0))]),
            ([Shard(2), Shard(2), Shard(0), Partial(), Partial(),
              h(Shard(1)) or R],
             [Shard(2), Shard(2), Shard(0), R, R, h(Shard(1)), Shard(2),
              Shard(1), st(Shard(2))])]


@functools.lru_cache(maxsize=None)
def register() -> None:
    """Install the rules of the six LM operators (idempotent)."""
    from torch.distributed.tensor.experimental import register_sharding

    from .flash_attention import ops as fa
    from .mamba_scan import ops as ms
    register_sharding(fa.FWD)(functools.partial(_fa_fwd, lse=False))
    register_sharding(fa.FWD_LSE)(functools.partial(_fa_fwd, lse=True))
    register_sharding(fa.BWD)(_fa_bwd)
    register_sharding(ms.FWD)(functools.partial(_scan_fwd, states=False))
    register_sharding(ms.FWD_STATES)(
        functools.partial(_scan_fwd, states=True))
    register_sharding(ms.BWD)(_scan_bwd)
