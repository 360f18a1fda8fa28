"""Pipeline parallelism: the reference's ``repro/parallel/pipeline.py``, a
GPipe schedule over the "stage" dimension of a ``DeviceMesh``.

Stages own contiguous layer groups (``split_stages``); microbatches stream
through: at tick t, stage s runs microbatch t - s, so a step of M
microbatches over S stages takes M + S - 1 ticks and idles the classic
bubble (S - 1) / (M + S - 1).  The program is SPMD as the reference's
``shard_map``: every rank runs ``pipeline_forward`` with its own stage's
parameters.  The stage hop is an ``all_to_all_single`` in which each
stage sends its activation to the next one alone (the reference's
``ppermute`` over [(i, i + 1)]), a functional collective that autograd
differentiates (the gradient hops back) and that ``graph_analysis`` counts
as a ``collective-permute``.  The last stage's outputs then reach every
stage through a masked all-reduce, as the reference's masked ``psum``;
its backward passes each rank's gradient through unchanged (each rank
holds the same loss, so the last stage's gradient is the loss's).

Layout contract:
  * ``params``: this rank's stage of ``split_stages`` (the reference's
    stage-sharded parameters, one stage a rank);
  * ``x_mb``: (n_micro, mb, ...) microbatched inputs, the same on every
    stage (only stage 0 reads them);
  * returns (n_micro, mb, ...) outputs, the last stage's, on every stage.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def _stage_index(mesh, axis: str) -> tuple:
    """(this rank's stage, the stage count, the stage dim's group)."""
    dim = mesh.mesh_dim_names.index(axis)
    return (mesh.get_local_rank(dim), mesh.size(dim),
            mesh.get_group(dim))


def _local(fn, y: torch.Tensor, *args):
    """``fn`` on ``y``'s local shard when ``y`` is a DTensor (a stage's
    activations laid out on its (data, model) mesh: each rank trades its
    own shard with the same position of the next stage), the result laid
    out as ``y``; else ``fn(y)``.  Differentiable."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor):
        return fn(y, *args)
    outs = fn(y.to_local(), *args)
    wrap = lambda t: DTensor.from_local(  # noqa: E731
        t, y.device_mesh, y.placements, run_check=False, shape=y.shape,
        stride=y.stride())
    return tuple(map(wrap, outs)) if isinstance(outs, tuple) else wrap(outs)


def _hop(y: torch.Tensor, s: int, stages: int, group) -> tuple:
    """Send ``y`` to stage s + 1 and receive stage s - 1's: (the next
    input, zeros on stage 0; the collective's output itself).
    Differentiable."""
    return _local(_hop_local, y, s, stages, group)


def _hop_local(y: torch.Tensor, s: int, stages: int, group) -> tuple:
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd, wait_tensor)
    rows = y.shape[0]
    send = [rows if d == s + 1 else 0 for d in range(stages)]
    recv = [rows if d == s - 1 else 0 for d in range(stages)]
    sent = y if s < stages - 1 else y[:0]      # the last stage sends none
    out = wait_tensor(all_to_all_single_autograd(sent.contiguous(), recv,
                                                 send, group))
    # the output of stage 0 (nothing received) is empty: the result
    # keeps y's shape so that it lays out as y
    return ((torch.zeros_like(y) if s == 0 else out.view_as(y)),
            out if s else y.new_zeros(y.shape) + out.sum())


class _Gather(torch.autograd.Function):
    """All-reduce (sum) of the masked outputs; the gradient passes through
    (every rank's loss is the same replicated loss)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed._functional_collectives import (all_reduce,
                                                               wait_tensor)
        return wait_tensor(all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_forward(stage_fn: Callable, mesh, axis: str, params, x_mb):
    """Run the pipeline.  ``stage_fn(stage_params, x) -> y`` applies ONE
    stage's layer group (same shape and dtype in and out); ``params`` is
    this rank's stage."""
    s, stages, group = _stage_index(mesh, axis)
    n_micro = x_mb.shape[0]
    buf = torch.zeros_like(x_mb[0])
    outs: List[torch.Tensor] = []
    # every hop's output enters the result with weight 0: each rank's
    # backward then runs every hop's backward (the gradient hops back),
    # in the same order on every rank, whatever the stage uses
    tie = 0.0
    for t in range(n_micro + stages - 1):
        if s == 0:
            xin = x_mb[t] if t < n_micro else torch.zeros_like(x_mb[0])
        else:
            xin = buf
        y = stage_fn(params, xin)
        buf, received = _hop(y, s, stages, group)
        tie = tie + received.sum() * 0.0
        if s == stages - 1 and 0 <= t - (stages - 1) < n_micro:
            outs.append(y)
    if s == stages - 1:
        local = torch.stack(outs)
    else:
        local = torch.zeros_like(x_mb)
    return _local(lambda t: _Gather.apply(t, group), local + tie)


def split_stages(layers, stages: int) -> list:
    """The layers split into ``stages`` contiguous groups: of an
    ``nn.ModuleList`` (one module a layer), ``ModuleList``s; of a tensor
    stacked on a leading layer axis, its slices (the reference reshapes
    its (L, ...) leaves to (stages, L / stages, ...))."""
    L = len(layers)
    if L % stages:
        raise ValueError(f"split_stages: {L} layers do not split into "
                         f"{stages} stages")
    g = L // stages
    return [layers[i * g:(i + 1) * g] for i in range(stages)]


def bubble_frac(stages: int, n_micro: int) -> float:
    """The GPipe schedule's idle share: (S - 1) / (M + S - 1)."""
    return (stages - 1) / (n_micro + stages - 1)
