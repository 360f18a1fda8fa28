"""Zero-allocation stand-ins for every model input: tensors on
``device="meta"``, the counterpart of the reference's ``ShapeDtypeStruct``
specs (``repro/launch/specs.py``).  ``input_specs(arch, shape)`` is the one
source of input shapes for the step analysis (``launch.graph_analysis``),
the dry-run's model terms (``launch.dryrun``) and the benchmarks.

A spec carries a shape and a dtype and no storage.  Parameters are the
model's own parameter module built on meta (no init draws: a spec never
runs one), in float32 for training and, for serving, in the dtypes of the
reference's serving checkpoints (``params_specs``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs import get_config
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.model import build_model, lm_module

N_PATCHES = 1024          # vision stub: patches spliced into the prefix
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A spec: a tensor of ``shape`` and ``dtype`` on meta."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=META)


def batch_specs(cfg: ModelConfig, B: int, S: int,
                with_labels: bool) -> Dict:
    out = {"tokens": sds((B, S), torch.int32)}
    if with_labels:
        out["labels"] = sds((B, S), torch.int32)
    if cfg.family == "encdec":
        out["audio_embeds"] = sds((B, cfg.enc_positions, cfg.d_model),
                                  torch.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = sds((B, min(N_PATCHES, S), cfg.d_model),
                                  torch.float32)
        out["positions"] = sds((B, S, 3), torch.int32)
    return out


# the layer stacks, one module a layer here and one leaf with a leading
# layer axis in the reference's parameter tree
STACKS = ("blocks", "encoder", "decoder")


def params_specs(cfg: ModelConfig, serve: bool = False) -> nn.Module:
    """The parameter module of ``cfg`` on meta (float32; with ``serve``
    every leaf of two or more dims of the reference's tree bf16, as its
    serving checkpoints: the matrices, and in the layer stacks also the
    per-layer norms and biases, which are (L, d) leaves there; the final
    norm stays float32)."""
    module = lm_module(cfg, META)
    if serve:
        for mname, m in module.named_modules():
            stacked = mname.split(".")[0] in STACKS
            for name, p in m.named_parameters(recurse=False):
                if p.dim() + stacked >= 2 and p.dtype == torch.float32:
                    setattr(m, name, nn.Parameter(
                        sds(p.shape, torch.bfloat16), requires_grad=False))
    return module


def cache_specs(cfg: ModelConfig, B: int, max_seq: int):
    """The family's empty cache (``Model.init_cache``) on meta."""
    return build_model(cfg, META).init_cache(B, max_seq)


def input_specs(arch: str, shape_name: str) -> Dict:
    """Everything the step function needs, as specs.

    kind='train':   {params (+ the optimizer state via
                    ``launch.train.train_state_specs``), batch}
    kind='prefill': {params, batch, cache}
    kind='decode':  {params, tokens (B, 1), cache (filled to seq_len),
                    index}
    """
    cfg = get_config(arch)
    sc: ShapeConfig = SHAPES[shape_name]
    B, S = sc.global_batch, sc.seq_len
    out: Dict = {"cfg": cfg, "shape": sc,
                 "params": params_specs(cfg, serve=(sc.kind != "train"))}
    if sc.kind == "train":
        out["batch"] = batch_specs(cfg, B, S, with_labels=True)
    elif sc.kind == "prefill":
        out["batch"] = batch_specs(cfg, B, S, with_labels=False)
        out["cache"] = cache_specs(cfg, B, S + cfg.meta_tokens)
    else:  # decode: one new token against a cache of seq_len
        out["tokens"] = sds((B, 1), torch.int32)
        out["cache"] = cache_specs(cfg, B, S + cfg.meta_tokens)
        out["index"] = sds((), torch.int32)
    return out
