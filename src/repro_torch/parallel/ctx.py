"""Activation-sharding context: the reference's ``repro/parallel/ctx.py``.

A launcher installs ``activation_sharding(mesh, pc)`` around a sharded
step; the model calls ``shard(x, (...logical dims...))`` at the few
layout-critical points (the same points as the reference's).  With no
context installed, or on a plain tensor, every call returns its input
unchanged, so a single-card run is bit for bit what it was.

Logical dim names:
    batch — the data axes ("pod", "data"), iff the dim divides
    seq   — "model" with ``seq_tp`` (Megatron sequence parallelism), else
            "data" iff ``seq_shard`` and batch did not claim it
    heads/tp/ep — the tensor axis, iff divisible
    cap   — "data" (MoE capacity), iff divisible
    None  — replicated

``resolve(shape, dims)`` gives the spec by the reference's two passes;
``shard`` ``redistribute``s a DTensor to that spec's placements.  On a
``DeviceMesh`` the context also lets plain tensors (positions, masks,
``arange``s a step makes) meet DTensors as replicated ones
(``implicit_replication``), as a traced JAX constant is.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from .sharding import (P, _axis_size, cache_spec, device_mesh_of, lay_out,
                       mesh_shape, placements)

_tls = threading.local()


def _state():
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, pc):
    """Install the context for ``mesh`` and ``pc``
    (``models.config.ParallelConfig``).  Activation BATCH sharding always
    uses the data axes; ``pc.fsdp_axes`` only controls weight sharding."""
    shape = mesh_shape(mesh)
    fs = tuple(a for a in ("pod", "data") if a in shape)
    tp = pc.tensor_axis if pc.tensor_axis in shape else None
    prev = _state()
    _tls.ctx = dict(mesh=mesh, pc=pc, shape=shape, fs=fs or None, tp=tp,
                    seq_shard=bool(pc.seq_shard),
                    seq_tp=bool(getattr(pc, "seq_tp", False)))
    try:
        if device_mesh_of(mesh) is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _tls.ctx = prev


def active() -> bool:
    return _state() is not None


def cache_layout(cfg, init_cache):
    """``init_cache`` whose cache, under a context on a ``DeviceMesh``, is
    laid out as DTensors by ``sharding.cache_spec`` (the reference's
    decode-cache layouts); without one, the plain cache."""
    @functools.wraps(init_cache)
    def laid_out(batch_size: int, max_seq: int):
        cache = init_cache(batch_size, max_seq)
        c = _state()
        if c is None or device_mesh_of(c["mesh"]) is None:
            return cache
        return lay_out(cache, cache_spec(cfg, c["pc"], c["mesh"],
                                         batch_size), c["mesh"])
    return laid_out


def resolve(shape: Tuple[int, ...], dims: Tuple[Optional[str], ...]) -> P:
    """The spec of a tensor of ``shape`` under the installed context, the
    reference's resolution: pass 1 gives the tensor axis to heads / tp /
    ep, pass 2 the batch, sequence and capacity dims."""
    ctx = _state()
    ms, fs, tp = ctx["shape"], ctx["fs"], ctx["tp"]
    used = set()
    spec = [None] * len(dims)
    for i, (d, name) in enumerate(zip(shape, dims)):
        if name in ("heads", "tp", "ep"):
            if tp and tp not in used and d % ms.get(tp, 1) == 0:
                spec[i] = tp
                used.add(tp)
    for i, (d, name) in enumerate(zip(shape, dims)):
        if spec[i] is not None:
            continue
        if name == "batch":
            if fs and "batch" not in used and d % _axis_size(ms, fs) == 0:
                spec[i] = fs
                used.add("batch")
        elif name == "seq":
            if (ctx["seq_tp"] and tp and tp not in used
                    and d % ms.get(tp, 1) == 0):
                spec[i] = tp
                used.add(tp)
            elif (ctx["seq_shard"] and "batch" not in used
                    and "data" not in used
                    and "data" in ms and d % ms["data"] == 0):
                spec[i] = "data"
                used.add("data")
        elif name == "cap":
            if ("data" not in used and "data" in ms
                    and d % ms["data"] == 0):
                spec[i] = "data"
                used.add("data")
    return P(*spec)


def shard(x, dims: Tuple[Optional[str], ...]):
    """``x`` laid out as ``dims`` resolve under the installed context (a
    DTensor is redistributed); without a context, on a plain tensor or
    on a rank mismatch, ``x`` itself."""
    ctx = _state()
    if ctx is None or x.dim() != len(dims):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(resolve(tuple(x.shape), dims), ctx["mesh"])
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor whose layout the reshape cannot
    carry (a sharded dim split into parts the mesh does not divide, as 6
    heads of a 16-way sharded projection) is first replicated over the
    dims from the first one the reshape changes — what GSPMD does for the
    reference's reshape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        k = 0
        while k < min(x.dim(), len(shape)) and x.shape[k] == shape[k]:
            k += 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim >= k else p
              for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(*shape)


def gather_inner(x):
    """``x`` (a DTensor of 3 or more dims) with its inner dims (all but the
    first and the last) replicated: the sequence all-gather of Megatron
    sequence parallelism before a projection, so that the projection's
    rows (batch x sequence) stay sharded on the batch alone.  Anything
    else is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or x.dim() < 3:
        return x
    pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
          else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    local = x.to_local()
    if local.is_contiguous():
        return x
    # an uneven shard's padded gather leaves its local tensor a slice,
    # which the projection's flattening view cannot take
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def gather_fsdp(w, x=None):
    """``w`` (a weight DTensor) replicated over every mesh dim but the
    tensor axis of the installed context, as ZeRO-3 / FSDP gathers a
    weight sharded over the data axes before computing with it (its
    gradient is reduce-scattered back to the shards) — where its shard is
    no larger than the shard of the input ``x`` it meets.  Otherwise (a
    decode step's few rows) ``w`` stays sharded and DTensor moves the
    activations instead, as a partitioner pricing both would; gathering
    always would leave the larger moving (a train step's microbatch
    contracted over the data axes, every rank holding the whole batch's
    output as a partial sum).  Without a context, or on anything but a
    DTensor, ``w`` itself."""
    from torch.distributed.tensor import DTensor, Replicate
    c = _state()
    if c is None or not isinstance(w, DTensor):
        return w
    if x is not None and _local(w).numel() * w.element_size() > \
            _local(x).numel() * x.element_size():
        return w
    names = w.device_mesh.mesh_dim_names or ()
    pl = [p if name == c["tp"] else Replicate()
          for name, p in zip(names, w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def _local(t):
    """A DTensor's local shard (no autograd node); any other tensor."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _on_mesh(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor is the same on every
    rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def lookup(table, index, dtype):
    """The rows ``index`` of ``table`` cast to ``dtype`` (an embedding
    lookup).  On a DTensor table under a context: the vocabulary-parallel
    lookup of Megatron, on each rank's shards — the table cast and
    gathered over the FSDP axes, each rank looking up the indices that
    fall in its block of the vocabulary (zeros for the others), the rows
    a partial sum over the tensor axis and laid out on the index's other
    mesh dims as the index is; the table's gradient a partial sum over
    the mesh dims the index is sharded on.  (DTensor's own indexing
    builds the gradient in zeros of the whole table on every rank, and
    some versions refuse batch-sharded indices.)  Anything else is
    ``table[index]`` cast."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if _state() is None or not isinstance(table, DTensor):
        return table[index].to(dtype)
    table = gather_fsdp(table.to(dtype))
    mesh = table.device_mesh
    vocab = [k for k, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    index = _on_mesh(index, mesh)
    if any(not isinstance(index.placements[k], Replicate) for k in vocab):
        index = index.redistribute(mesh, [
            Replicate() if k in vocab else p
            for k, p in enumerate(index.placements)])
    lo, n = 0, table.shape[0]
    for k in vocab:
        n //= mesh.size(k)
        lo += mesh.get_coordinate()[k] * n
    grad = [p if k in vocab else
            Partial() if isinstance(index.placements[k], Shard) else
            Replicate() for k, p in enumerate(table.placements)]
    local = table.to_local(grad_placements=grad)
    idx = index.to_local()
    inside = (idx >= lo) & (idx < lo + n)
    out = torch.nn.functional.embedding(torch.where(inside, idx - lo, 0),
                                        local)
    if vocab:
        out = out * inside.unsqueeze(-1).to(out.dtype)
    shape = tuple(index.shape) + (table.shape[1],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(
        out, mesh, [Partial() if k in vocab else p
                    for k, p in enumerate(index.placements)],
        run_check=False, shape=shape, stride=stride)


def take_last(x, index):
    """``x.gather(-1, index[..., None])[..., 0]`` (``index`` an int64 tensor
    of ``x``'s leading shape).  On a DTensor whose last dim is whole on
    every rank, each rank takes from its own rows (the index laid out as
    they are; a plain index is the same on every rank): DTensor's own
    gather would build the gradient in zeros of ``x``'s global shape on
    every rank (the loss's logits, batch x sequence x vocabulary).
    Anything else is ``x``'s plain gather."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = x.dim() - 1
    if not isinstance(x, DTensor) or not all(
            isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim < last)
            for p in x.placements):
        return x.gather(-1, index.unsqueeze(-1)).squeeze(-1)
    index = _on_mesh(index, x.device_mesh).redistribute(
        x.device_mesh, x.placements).to_local()
    local = x.to_local().gather(-1, index.unsqueeze(-1)).squeeze(-1)
    shape = tuple(x.shape[:last])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(last))
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=shape, stride=stride)


def row_block(x, i: int, n: int):
    """Block ``i`` of ``n`` equal blocks of ``x``'s leading dim (a
    microbatch of a batch).  On a DTensor whose leading dim is sharded
    evenly, block ``i`` of each rank's own rows, laid out as ``x`` is: a
    rank-local split, as a data-parallel trainer accumulates over its own
    rows (slicing the DTensor would gather the whole batch on every rank,
    once a microbatch).  Anything else is the plain slice."""
    from torch.distributed.tensor import DTensor, Shard
    b = x.shape[0] // n
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in x.placements):
        local = x.to_local()
        ranks = x.shape[0] // max(local.shape[0], 1)
        if local.shape[0] * ranks == x.shape[0] and local.shape[0] % n == 0:
            lb = local.shape[0] // n
            shape = (b,) + tuple(x.shape[1:])
            stride = tuple(math.prod(shape[k + 1:])
                           for k in range(len(shape)))
            return DTensor.from_local(local[i * lb:(i + 1) * lb],
                                      x.device_mesh, x.placements,
                                      run_check=False, shape=shape,
                                      stride=stride)
    return x[i * b:(i + 1) * b]


def combine_experts(eq: str, ye, comb):
    """``einsum(eq, ye, comb)``, the experts' outputs ``ye`` (expert label
    ``e``) combined over experts and capacity (label ``c``).  einsum
    flattens the contracted labels in alphabetical order, capacity
    before expert; on DTensors, whose experts are sharded, the expert
    label is renamed to sort first, since a view that merges dims keeps a
    shard only on the outer one (some versions refuse the other).  A
    plain tensor keeps the equation."""
    from torch.distributed.tensor import DTensor
    if isinstance(ye, DTensor):
        eq = eq.replace("e", "a")
    return torch.einsum(eq, ye, comb)


class _OwnGradLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward output
    was (a partial sum read as replicated)."""

    @staticmethod
    def forward(fctx, x):
        from torch.distributed.tensor import Replicate
        fctx.mesh = x.device_mesh
        fctx.placements = tuple(Replicate() if p.is_partial() else p
                                for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        from torch.distributed.tensor import DTensor
        if isinstance(g, DTensor) and tuple(g.placements) != fctx.placements:
            g = g.redistribute(fctx.mesh, fctx.placements)
        return g


def own_grad_layout(y):
    """``y`` (a projection's output), whose gradient arrives in ``y``'s own
    layout: the gradient of a residual stream sharded on its sequence
    (Megatron sequence parallelism) is gathered back onto the batch alone
    before the projection's backward flattens (batch x sequence) rows,
    which DTensor takes only with the sequence whole (and some versions
    refuse).  Anything but a DTensor is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor):
        return y
    return _OwnGradLayout.apply(y)


def _seq_block(t):
    """(the mesh dims, this rank's offset, the block length) of a DTensor
    whose dim 1 (the sequence) is sharded in even blocks, nested in mesh
    dim order; None for anything else."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    dims = [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == 1]
    if not dims or t.shape[1] % math.prod(mesh.size(d) for d in dims):
        return None
    coord, span, offset = mesh.get_coordinate(), t.shape[1], 0
    for d in dims:
        span //= mesh.size(d)
        offset += coord[d] * span
    return dims, offset, span


def sequence_sharded(t) -> bool:
    """Whether ``t`` is a DTensor whose dim 1 (the sequence) is sharded in
    even blocks (the layout ``split_key_attention`` reads)."""
    return _seq_block(t) is not None


def rows_matmul(x, w):
    """``x @ w`` (``w`` a weight, (d_in, d_out)).  On a DTensor ``x``, each
    rank multiplies its own rows of ``x`` (its blocks of every dim but the
    last, which is gathered whole) by the whole weight, gathered over
    every mesh dim: the rows keep their layout, a sequence sharded over
    the tensor axis included, where DTensor's own product flattens
    (batch x sequence) rows, which some versions refuse with the
    sequence sharded.  The weight's gradient is a partial sum over the
    mesh dims that split the rows.  Anything else is the plain
    product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return x @ w
    mesh, last = x.device_mesh, x.dim() - 1
    if any(isinstance(p, Shard) and p.dim == last for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Shard)
                                  and p.dim == last else p
                                  for p in x.placements])
    if isinstance(w, DTensor):
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if isinstance(p, Shard)
                             else Replicate() for p in x.placements])
    local = x.to_local() @ w
    shape = tuple(x.shape[:last]) + (w.shape[-1],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, x.placements, run_check=False,
                              shape=shape, stride=stride)


def split_key_attention(q, k, v, kv_valid_len):
    """Single-token decode attention over a cache whose key sequence is
    sharded (the reference's ``decode_kv="sequence"`` layout, reduced by
    flash-decoding's partial softmax instead of gathering the cache): each
    rank runs the attention kernel with its log-sum-exp over its own key
    block (the keys below ``kv_valid_len`` that fall in it), and the
    blocks' outputs combine by their softmax weights through three
    all-reduces over the sequence's mesh dims.  Returns None where this
    does not apply (no DTensor cache with an evenly sharded sequence, more
    than one query, or a query sharded on its sequence), and the caller
    attends as usual."""
    from torch.distributed.tensor import DTensor, Shard
    block = _seq_block(k)
    if (block is None or not isinstance(q, DTensor) or q.shape[1] != 1
            or kv_valid_len is None
            or any(isinstance(p, Shard) and p.dim == 1
                   for p in q.placements)):
        return None
    import torch
    from torch.distributed._functional_collectives import (all_reduce,
                                                           wait_tensor)

    from ..kernels.flash_attention.ops import flash_attention_fwd_lse
    dims, offset, span = block
    mesh = k.device_mesh
    v = v.redistribute(mesh, k.placements)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    valid = max(0, min(int(kv_valid_len) - offset, span))
    if valid:
        out, lse = flash_attention_fwd_lse(ql.contiguous(), kl, vl, "none",
                                           0, valid)
    else:                                   # no visible key in this block
        out = ql.new_zeros(ql.shape[:3] + (vl.shape[3],))
        lse = torch.full((ql.shape[0], ql.shape[2], 1), -torch.inf,
                         device=ql.device)
    m = lse
    for d in dims:
        m = wait_tensor(all_reduce(m, "max", mesh.get_group(d)))
    w = torch.exp(lse - m)                                  # (B, H, 1)
    num = out.float() * w.transpose(1, 2)[..., None]
    for d in dims:
        num = wait_tensor(all_reduce(num, "sum", mesh.get_group(d)))
        w = wait_tensor(all_reduce(w, "sum", mesh.get_group(d)))
    res = (num / w.transpose(1, 2)[..., None]).to(ql.dtype).contiguous()
    shape = tuple(q.shape[:3]) + (v.shape[3],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(4))
    return DTensor.from_local(res, mesh, q.placements, run_check=False,
                              shape=shape, stride=stride)


def write_seq(cache, new, index: int) -> None:
    """``cache[:, index:index + S] = new`` in place (S = ``new``'s length):
    on a cache whose sequence dim is sharded, each rank writes the part of
    ``new`` that falls in its own block (the update is local, as the
    reference's ``dynamic_update_slice`` on a sharded cache is), instead
    of DTensor gathering the cache to write a slice of it."""
    from torch.distributed.tensor import DTensor, Replicate
    S = new.shape[1]
    block = _seq_block(cache)
    if block is None:
        cache[:, index:index + S] = new
        return
    dims, offset, span = block
    if isinstance(new, DTensor):                # whole over the blocks
        pl = [Replicate() if i in dims else p
              for i, p in enumerate(new.placements)]
        new = new.redistribute(new.device_mesh, pl).to_local()
    lo, hi = max(index, offset), min(index + S, offset + span)
    if lo < hi:
        cache.to_local()[:, lo - offset:hi - offset] = new[:, lo - index:
                                                          hi - index]
