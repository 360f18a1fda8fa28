"""The dry-run's model terms: the pure part of the reference's
``repro/launch/dryrun.py``.

* ``default_parallel(arch, shape)`` — the advisor-chosen layout of a cell
  (a ``ParallelConfig`` and the model-config overrides it implies);
* ``model_flops_for(cfg, sc)`` — the useful FLOPs of one step, 6 N D to
  train, 2 N D to prefill, 2 N B to decode (N the active parameters);
* ``model_min_bytes_for(cfg, sc, specs)`` — the bytes a decode step must
  stream: the bf16 active weights and the whole cache of
  ``launch.specs.input_specs``.

These are the numerators of a step's shares of peak (``graph_analysis.
roofline``).  Lowering a cell on a device mesh (the reference's
``lower_cell``, ``run_cell`` and command line) needs the multi-rank layer
and is not ported yet.
"""

from __future__ import annotations

from torch.utils._pytree import tree_leaves

from ..configs import ALIASES, get_config
from ..models.config import SHAPES, ParallelConfig


def default_parallel(arch: str, shape_name: str, overrides=None):
    """The advisor-chosen layout per cell, after the reference's hillclimb.
    Returns (ParallelConfig, model-config overrides)."""
    cfg0 = get_config(ALIASES.get(arch, arch))
    moe = cfg0.n_experts > 0
    kw = dict(fsdp_axes=("pod", "data"), tensor_axis="model",
              decode_kv="auto", remat="dots")
    cfgk = {}
    kind = SHAPES[shape_name].kind
    if kind == "train":
        # full remat in groups of 4 + gradient accumulation (fits HBM);
        # Megatron-style sequence parallelism for the non-recurrent,
        # non-MoE families (it reshards MoE dispatch/SSM convs badly)
        kw["remat"] = "full"
        kw["microbatch"] = 16 if moe else 8
        cfgk["remat_group"] = 2 if moe else 4
        if cfg0.family in ("dense", "vlm", "encdec"):
            kw["seq_tp"] = True
    if moe and kind in ("train", "prefill"):
        # group-local dispatch: one-hot dispatch FLOPs drop ~G-fold
        cfgk.update(moe_groups=64, capacity_factor=1.0)
    if shape_name == "long_500k":
        kw["seq_shard"] = True
    if overrides:
        kw.update(overrides)
    return ParallelConfig(**kw), cfgk


def model_flops_for(cfg, sc) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (prefill) / 2 N B (decode),
    N = active params (MoE counts top-k only)."""
    n = cfg.active_param_count()
    if sc.kind == "train":
        return 6.0 * n * sc.global_batch * sc.seq_len
    if sc.kind == "prefill":
        return 2.0 * n * sc.global_batch * sc.seq_len
    return 2.0 * n * sc.global_batch


def model_min_bytes_for(cfg, sc, specs) -> float:
    """Compulsory per-step HBM stream: decode must read the active weights
    (bf16) and the whole KV / SSM cache (``specs["cache"]``) once per token
    step."""
    if sc.kind != "decode":
        return 0.0
    total = 2.0 * cfg.active_param_count()
    for leaf in tree_leaves(specs.get("cache", {})):
        total += float(leaf.numel() * leaf.element_size())
    return total
