"""Pipeline-parallel dry run: the reference's ``repro/launch/dryrun_pp.py``,
proving the GPipe pipeline composes with data x tensor parallelism at 512
ranks.

Mesh (stage 4, data 8, model 16) = 512 ranks of a fake world
(``launch.mesh.fake_world``).  A qwen2-72b-class decoder is split into 4
pipeline stages (20 layers each); each rank holds its stage's layers as
DTensors on its (data, model) sub-mesh (the wq / wk / wv / wg / wu
matrices over (data, model), wo / wd over (model, data), the rest
replicated, as the reference's), and microbatches stream through
``parallel.pipeline.pipeline_forward``.  The loss and gradient of the
pipelined step are traced on fake tensors as rank 0 (stage 0) runs them
(``graph_analysis.analyze``).  Artifact:
``artifacts/dryrun_torch/pp_qwen2_72b__train_4k.json`` with the
reference's fields (``bubble_frac``, ``flops_per_device``,
``collective_permute_wire``, ``memory``; ``compile_s`` null, ``lower_s``
the trace's seconds).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pp [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
from torch import nn

from ..configs import get_config
from ..models import transformer as Tr
from ..models.config import SHAPES
from ..parallel.pipeline import bubble_frac, pipeline_forward
from ..runtime import resolve_device
from . import graph_analysis as G
from .dryrun import ARTIFACTS, _world
from .specs import META, sds

STAGES, DATA, MODEL = 4, 8, 16
MICRO = 8


def _stage_spec(name: str, ndim: int):
    """The reference's ``spec_for``: the projections' two dims over (data,
    model) or (model, data), the rest replicated."""
    parts = name.split(".")
    leaf = parts[-2] if parts[-1] == "w" else parts[-1]
    if ndim == 2 and leaf in ("wq", "wk", "wv", "wg", "wu"):
        return ("data", "model")
    if ndim == 2 and leaf in ("wo", "wd"):
        return ("model", "data")
    return (None,) * ndim


def pp_cell(cfg=None, device="cuda", shape_name: str = "train_4k"):
    """Trace the pipelined step; returns the artifact dict."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from ..kernels.sharding import register
    from ..parallel.sharding import P, distribute, placements
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or get_config("qwen2_72b"), remat="full",
                              remat_group=4)
    sc = SHAPES[shape_name]
    per_stage = cfg.n_layers // STAGES
    mb = sc.global_batch // MICRO
    register()
    with _world(STAGES * DATA * MODEL):
        mesh = DeviceMesh(dev.type, torch.arange(STAGES * DATA * MODEL)
                          .reshape(STAGES, DATA, MODEL),
                          mesh_dim_names=("stage", "data", "model"))
        sub = mesh["data", "model"]
        blocks = nn.ModuleList(Tr.Block(cfg, "dense", META)
                               for _ in range(per_stage))
        for name, p in list(blocks.named_parameters()):
            pl = placements(P(*_stage_spec(name, p.dim())), sub)
            owner, _, attr = name.rpartition(".")
            setattr(blocks.get_submodule(owner), attr, nn.Parameter(
                distribute(p.detach(), sub, pl)))
        x = distribute(sds((MICRO, mb, sc.seq_len, cfg.d_model),
                           torch.bfloat16), sub, (Shard(1), Replicate()))

        def stage_fn(p_stage, h):
            pos = torch.arange(h.shape[1], device=dev)[None].expand(
                h.shape[0], h.shape[1])
            return Tr.stack_apply(p_stage, cfg, h, pos)[0]

        def step(params, xs):
            # plain tensors the layers make (positions) meet the DTensors
            # as replicated ones
            with implicit_replication():
                y = pipeline_forward(stage_fn, mesh, "stage", params, xs)
                loss = (y.float() ** 2).mean()
                loss.backward()
            return loss.detach()
        t0 = time.time()
        an = G.analyze(step, blocks, x, device=dev)
        dt = time.time() - t0
    return {
        "name": f"pp_{cfg.name.replace('-', '_').replace('.', '_')}"
                f"__{shape_name}",
        "mesh": f"stage{STAGES} x data{DATA} x model{MODEL} = "
                f"{STAGES * DATA * MODEL}",
        "status": "ok", "compile_s": None, "lower_s": round(dt, 1),
        "microbatches": MICRO,
        "bubble_frac": bubble_frac(STAGES, MICRO),
        "flops_per_device": an.flops,
        "bytes_per_device": an.bytes_heavy,
        "collective_permute_wire": an.wire_bytes["collective-permute"],
        "wire_bytes": an.wire_bytes,
        "memory": {"argument_size_in_bytes": an.input_bytes,
                   "peak_bytes": an.peak_bytes,
                   "total_hbm_bytes": an.peak_bytes},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda",
                    help="the fake tensors' device (cuda unless cpu)")
    args = ap.parse_args(argv)
    art = pp_cell(device=args.device)
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    out = ARTIFACTS / "pp_qwen2_72b__train_4k.json"
    out.write_text(json.dumps(art, indent=1, default=float))
    print(f"PP dry-run ok: trace {art['lower_s']}s, "
          f"bubble={art['bubble_frac']:.2f}, ppermute wire="
          f"{art['collective_permute_wire'] / 1e9:.1f}GB -> {out}")


if __name__ == "__main__":
    main()
