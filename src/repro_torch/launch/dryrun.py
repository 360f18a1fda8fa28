"""Multi-pod dry run: the reference's ``repro/launch/dryrun.py``.

For every (architecture x input shape x mesh) cell: install a fake world
of 512 ranks in this one process (``launch.mesh.fake_world``), build the
production mesh, lay the parameters, optimizer state, batch and cache out
as DTensors by the advisor's layout (``default_parallel`` and
``parallel.sharding``), and trace the step once on fake tensors under the
activation-sharding context (``graph_analysis.analyze``: nothing is
allocated or launched) — then price it on the roofline and write
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``, apart from the
reference's TPU artifacts in ``artifacts/dryrun/``.

The artifact keeps the reference's keys.  ``lower_s`` is the trace's
seconds; ``compile_s`` and ``xla_cost_analysis`` have no counterpart and
hold null; ``memory`` holds the traced peak of live bytes a device
(``peak_bytes``, = ``total_hbm_bytes``) and the inputs' share of it.
FLOPs, bytes (the reference's heavy selection; ``bytes_all`` beside it)
and wire bytes are one device's (rank 0's): DTensor runs every operator on
the local shards and issues the collectives its layouts need, which the
counter sees.  The model terms:

* ``default_parallel(arch, shape)`` — the advisor-chosen layout of a cell
  (a ``ParallelConfig`` and the model-config overrides it implies);
* ``model_flops_for(cfg, sc)`` — the useful FLOPs of one step, 6 N D to
  train, 2 N D to prefill, 2 N B to decode (N the active parameters);
* ``model_min_bytes_for(cfg, sc, specs)`` — the bytes a decode step must
  stream: the bf16 active weights and the whole cache of
  ``launch.specs.input_specs``.

Autograd on fake CUDA tensors needs a build of PyTorch with CUDA, so on
one without (``device="cpu"``) the same step traces on fake CPU tensors.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
  python -m repro_torch.launch.dryrun --arch ... --set decode_kv=heads remat=full
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --layers 4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from ..configs import ALIASES, ARCH_IDS, cells, get_config
from ..core.constants import DEFAULT_H100
from ..models.config import SHAPES, ParallelConfig
from ..models.model import build_model
from ..optim.adamw import AdamWConfig, adamw_init
from ..parallel import sharding as Sh
from ..parallel.ctx import activation_sharding
from . import graph_analysis as G
from .mesh import fake_world, make_production_mesh
from .specs import input_specs

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
WORLD = 512          # the reference forces 512 host devices
TARGET = DEFAULT_H100  # prices the roofline and splits its wire tiers


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


@contextlib.contextmanager
def _world(n: int):
    """A fake world of ``n`` ranks unless a process group exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
    else:
        with fake_world(n):
            yield


def _batch(batch, cfg, pc, mesh, sc):
    bs = Sh.batch_spec(cfg, pc, mesh, sc.global_batch, sc.seq_len)
    return {k: Sh.distribute(v, mesh, Sh.placements(
        bs.get(k, Sh.P(*([None] * v.dim()))), mesh))
        for k, v in batch.items()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides=None, device="cuda", config=None):
    """Lay out and trace one cell; returns the artifact dict.  ``config``
    replaces ``arch``'s config (a reduced one, in the tests)."""
    from .train import make_train_step
    cfg = config or get_config(arch)
    sc = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if sc.name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped (full attention)"}
    overrides = dict(overrides or {})
    cfg_over = {k: overrides.pop(k) for k in list(overrides)
                if k in ("moe_impl", "capacity_factor", "moe_groups",
                         "remat_group")}
    pc, cfg_defaults = default_parallel(arch, shape_name, overrides or None)
    cfg_defaults.update(cfg_over)
    cfg = dataclasses.replace(cfg, remat=pc.remat, **cfg_defaults)
    with _world(WORLD):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        n_chips = mesh.size()
        model = build_model(cfg, device)
        rules = Sh.make_rules(pc)
        specs = input_specs(arch, shape_name, cfg)
        params = Sh.distribute_module(specs["params"], cfg, mesh, rules)
        if sc.kind == "train":
            opt_cfg = AdamWConfig()
            params.requires_grad_(True)
            state = {"params": params, "opt": adamw_init(opt_cfg, params)}
            fn = make_train_step(model, opt_cfg, microbatches=pc.microbatch)
            args = (state, _batch(specs["batch"], cfg, pc, mesh, sc))
        else:
            cache = Sh.lay_out(specs["cache"], Sh.cache_spec(
                cfg, pc, mesh, sc.global_batch), mesh)
            if sc.kind == "prefill":
                fn = model.prefill
                args = (params, _batch(specs["batch"], cfg, pc, mesh, sc),
                        cache)
            else:
                fn = model.decode_step
                tok = Sh.distribute(specs["tokens"], mesh, Sh.placements(
                    Sh.P(None, None), mesh))
                # the token at the cache's last position attends over
                # all of it (the reference traces the index as a scalar)
                args = (params, tok, cache, sc.seq_len + cfg.meta_tokens - 1)
        t0 = time.time()
        with activation_sharding(mesh, pc):
            an = G.analyze(fn, *args, device=device)
        t_lower = time.time() - t0
    mf = model_flops_for(cfg, sc)
    mb = model_min_bytes_for(cfg, sc, specs)
    rl = G.roofline(an.flops, an.bytes_heavy, an.total_wire_bytes, n_chips,
                    mf, mb, target=TARGET, group_wire=an.group_wire)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_chips": int(n_chips),
        "parallel": dataclasses.asdict(pc),
        "lower_s": round(t_lower, 1), "compile_s": None,
        "flops_per_device": an.flops, "bytes_per_device": an.bytes_heavy,
        "bytes_all_per_device": an.bytes_all,
        "xla_cost_analysis": None,
        "memory": {"argument_size_in_bytes": an.input_bytes,
                   "peak_bytes": an.peak_bytes,
                   "total_hbm_bytes": an.peak_bytes},
        "collectives": {"wire_bytes": an.wire_bytes,
                        "counts": an.collectives,
                        "total_wire_bytes": an.total_wire_bytes,
                        "inter_node_wire_bytes": G.inter_node_wire(
                            an.group_wire, TARGET.node_gpus)},
        "kernels": an.kernels, "operators": an.ops,
        "model_flops": mf, "roofline": rl.to_dict(),
    }


def cell_path(arch, shape, mesh_name, tag="") -> Path:
    sfx = f"__{tag}" if tag else ""
    return ARTIFACTS / f"{arch}__{shape}__{mesh_name}{sfx}.json"


def run_cell(arch, shape, mesh_name, skip_existing=False, overrides=None,
             tag="", device="cuda", config=None, out_dir=None):
    """Lower one cell and write its artifact (a failure records
    ``FAILED: ...`` and its traceback, as the reference's)."""
    out = cell_path(arch, shape, mesh_name, tag)
    if out_dir is not None:
        out = Path(out_dir) / out.name
    if skip_existing and out.exists():
        print(f"[skip] {out.name}")
        return json.loads(out.read_text())
    t0 = time.time()
    try:
        art = lower_cell(arch, shape, mesh_name == "multi", overrides,
                         device=device, config=config)
    except Exception as e:  # a failure here is a fault of the port
        art = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": f"FAILED: {type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(art, indent=1, default=float))
    st = art["status"]
    extra = ""
    if st == "ok":
        r = art["roofline"]
        extra = (f" frac={r['roofline_frac']:.3f} dom={r['bottleneck']}"
                 f" trace={art['lower_s']}s")
    print(f"[{time.strftime('%H:%M:%S')}] {arch} {shape} {mesh_name}: "
          f"{st}{extra} ({time.time() - t0:.0f}s)", flush=True)
    return art


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the fake tensors' device (cuda unless cpu)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (the trace's time "
                         "grows with the layers it unrolls)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="ParallelConfig overrides k=v")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        elif k == "fsdp_axes":
            v = tuple(x for x in v.split(",") if x)
        else:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        jobs = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
    else:
        arch = ALIASES.get(args.arch, args.arch)
        shapes = [args.shape] if args.shape else cells(arch)
        jobs = [(arch, s, m) for s in shapes for m in meshes]
    ok = failed = 0
    for arch, shape, m in jobs:
        cfg = None
        if args.layers:
            cfg = dataclasses.replace(get_config(arch), n_layers=args.layers)
        art = run_cell(arch, shape, m, args.skip_existing,
                       overrides or None,
                       args.tag or (f"L{args.layers}" if args.layers else ""),
                       device=args.device, config=cfg)
        if art["status"].startswith("FAILED"):
            failed += 1
        else:
            ok += 1
    print(f"done: {ok} ok, {failed} failed")
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
