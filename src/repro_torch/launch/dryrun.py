"""Multi-pod dry run: the reference's ``repro/launch/dryrun.py``.

For every (architecture x input shape x mesh) cell: install a fake world
of 512 ranks in this one process (``launch.mesh.fake_world``), build the
production mesh, lay the parameters, optimizer state, batch and cache out
as DTensors by the advisor's layout (``default_parallel`` and
``parallel.sharding``), and trace the step on fake tensors under the
activation-sharding context (``graph_analysis.analyze``: nothing is
allocated or launched) — then price it on the roofline and write
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``, apart from the
reference's TPU artifacts in ``artifacts/dryrun/``.

A cell is counted at its full depth and microbatch count by trip counts,
as the reference's HLO analysis multiplies a ``while`` body by its trips:
the step is traced at a few small counts (``trip_plan``) and every count
extrapolated (``graph_analysis.extrapolate``); ``lower_cell(...,
trips=False)`` traces every trip instead.  The multi-pod mesh lays
("pod", "data") out as one mesh dim of 32 ranks (``FlatMesh``: the same
ranks and layout, over which DTensor plans as on one pod's mesh) unless
the cell names "data" alone (``mesh.names_data_alone``).

The artifact keeps the reference's keys.  ``lower_s`` is the traces'
seconds; ``trips`` records the counts traced and the counts extrapolated
to; ``collectives.wire_sites`` holds the wire by the line of the port
that issued it (``--sites``); ``compile_s`` and ``xla_cost_analysis``
have no counterpart and hold null; ``memory`` holds the traced peak of live bytes a device
(``peak_bytes``, = ``total_hbm_bytes``) and the inputs' share of it.
FLOPs, bytes (the reference's heavy selection; ``bytes_all`` beside it)
and wire bytes are one device's (rank 0's): DTensor runs every operator on
the local shards and issues the collectives its layouts need, which the
counter sees (``collectives.group_wire``: the wire by the group's ranks,
which the roofline prices by fabric tier).  The model terms:

* ``default_parallel(arch, shape)`` — the advisor-chosen layout of a cell
  (a ``ParallelConfig`` and the model-config overrides it implies);
* ``model_flops_for(cfg, sc)`` — the useful FLOPs of one step, 6 N D to
  train, 2 N D to prefill, 2 N B to decode (N the active parameters);
* ``model_min_bytes_for(cfg, sc, specs)`` — the bytes a decode step must
  stream: the bf16 active weights and the whole cache of
  ``launch.specs.input_specs``.

Autograd on fake CUDA tensors needs a build of PyTorch with CUDA, so on
one without (``device="cpu"``) the same step traces on fake CPU tensors.
The whole grid (10 archs x 4 shapes x 2 meshes: 64 traced cells and 16
``long_500k`` cells of full-attention archs recorded as skipped) runs on
a machine with such a build, the card unused: 987 s in one process on
the host of an NVIDIA H100 80GB HBM3 (700.00 W), 216 s in four
(``--part I/4``, one a core; ``PERF.md``).  On a CPU-only build trace
reduced configs only.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh both [--skip-existing]
  python -m repro_torch.launch.dryrun --all --mesh both --part 0/4   # 1 of 4
  python -m repro_torch.launch.dryrun --table        # the artifacts' table
  python -m repro_torch.launch.dryrun --sites 3      # wire by issuing line
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch ... --set decode_kv=heads remat=full
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --layers 4
  python -m repro_torch.launch.dryrun --arch ... --layers 12 --unrolled  # yardstick
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


def _trace(arch, shape_name, cfg, pc, mesh, device, first=None):
    """Lay out and trace one step of ``cfg`` (its specs at this depth) on
    ``mesh``; with ``first``, the train step's first ``first`` microbatches
    only.  Returns (the analysis, its seconds)."""
    from .train import _train_step
    sc = SHAPES[shape_name]
    model = build_model(cfg, device)
    specs = input_specs(arch, shape_name, cfg)
    params = Sh.distribute_module(specs["params"], cfg, mesh,
                                  Sh.make_rules(pc))
    if sc.kind == "train":
        opt_cfg = AdamWConfig()
        params.requires_grad_(True)
        state = {"params": params, "opt": adamw_init(opt_cfg, params)}
        fn = _train_step(model, opt_cfg, pc.microbatch, first)
        args = (state, _batch(specs["batch"], cfg, pc, mesh, sc))
    else:
        cache = Sh.lay_out(specs["cache"], Sh.cache_spec(
            cfg, pc, mesh, sc.global_batch), mesh)
        if sc.kind == "prefill":
            fn = model.prefill
            args = (params, _batch(specs["batch"], cfg, pc, mesh, sc), cache)
        else:
            fn = model.decode_step
            tok = Sh.distribute(specs["tokens"], mesh, Sh.placements(
                Sh.P(None, None), mesh))
            # the token at the cache's last position attends over all of
            # it (the reference traces the index as a scalar)
            args = (params, tok, cache, sc.seq_len + cfg.meta_tokens - 1)
    t0 = time.time()
    with activation_sharding(mesh, pc):
        an = G.analyze(fn, *args, device=device)
    return an, time.time() - t0


def trip_plan(cfg, sc, pc, trips: bool = True):
    """The trip counts of a cell and the points to trace them at:
    [(name, lo, hi, target)] for each layer stack (``n_layers``; whisper's
    ``enc_layers`` apart) and, to train, the microbatches, and the remat
    group the traces keep.  A stack deeper than two remat groups (of the
    group its full depth runs in; one layer where nothing is remat) plus
    one is traced at one group and at two, at least two layers (the first
    layer holds a smaller peak than the later ones: the affine rule starts
    at the second) — a group of one layer, and a serving stack, at two
    layers and at three; the
    microbatches, past three, at the first two and the first three of the
    step's loop (the peak grows in the first two: the gradients appear in
    the first and accumulate from the second; past them a microbatch,
    a view of each rank's rows, adds the same bytes to the peak).  ``trips=False`` traces every trip
    (lo = hi = target)."""
    from ..models.transformer import remat_group
    train = sc.kind == "train"
    stacks = [("n_layers", cfg.n_layers)]
    if cfg.family == "encdec":
        stacks.insert(0, ("enc_layers", cfg.enc_layers))
    groups = {1}
    if train and cfg.remat != "none":
        groups = {cfg.remat_group if cfg.remat_group
                  and L % cfg.remat_group == 0 else remat_group(L)
                  for _, L in stacks}
    group = groups.pop() if len(groups) == 1 else None
    plan = []
    for name, L in stacks:
        lo = max(group or 1, 2)
        deep = trips and group is not None and L > lo + group
        plan.append((name, lo if deep else L, lo + group if deep else L, L))
    if train:
        M = pc.microbatch
        few = trips and M > 3
        plan.append(("microbatch", 2 if few else M, 3 if few else M, M))
    return plan, group


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides=None, device="cuda", config=None,
               trips: bool = True):
    """Lay out and trace one cell; returns the artifact dict.  ``config``
    replaces ``arch``'s config (a reduced one, in the tests).  The cell is
    counted at its full depth and microbatch count from a few traces at
    fewer trips (``trip_plan``, ``graph_analysis.extrapolate``);
    ``trips=False`` traces every trip (the yardstick of the tests)."""
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
    plan, group = trip_plan(cfg, sc, pc, trips)
    if group is not None:
        cfg = dataclasses.replace(cfg, remat_group=group)
    names = [name for name, *_ in plan]
    lo = tuple(p[1] for p in plan)
    hi = tuple(p[2] for p in plan)
    target = tuple(p[3] for p in plan)
    free = [i for i in range(len(plan)) if lo[i] != hi[i]]
    traces, seconds = {}, 0.0
    with _world(WORLD):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device,
                                    pc=pc)
        n_chips = mesh.size()
        for mask in range(1 << len(free)):
            point = tuple(hi[i] if i in free and mask >> free.index(i) & 1
                          else lo[i] for i in range(len(plan)))
            trip = dict(zip(names, point))
            m = trip.pop("microbatch", None)
            an, secs = _trace(
                arch, shape_name, dataclasses.replace(cfg, **trip), pc, mesh,
                device, first=None if m == pc.microbatch else m)
            traces[point] = an
            seconds += secs
    an = traces[target] if target in traces else G.extrapolate(
        traces, lo, hi, target)
    specs = input_specs(arch, shape_name, cfg)
    mf = model_flops_for(cfg, sc)
    mb = model_min_bytes_for(cfg, sc, specs)
    rl = G.roofline(an.flops, an.bytes_heavy, an.total_wire_bytes, n_chips,
                    mf, mb, target=TARGET, group_wire=an.group_wire)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_chips": int(n_chips),
        "parallel": dataclasses.asdict(pc),
        "lower_s": round(seconds, 1), "compile_s": None,
        "trips": {"traced": {n: sorted({lo[i], hi[i]})
                             for i, n in enumerate(names)},
                  "extrapolated_to": dict(zip(names, target)),
                  "traces": len(traces)},
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
                            an.group_wire, TARGET.node_gpus),
                        "group_wire": [[list(r), w] for r, w in
                                       sorted(an.group_wire.items())],
                        "wire_sites": dict(sorted(
                            an.wire_sites.items(), key=lambda kv: -kv[1]))},
        "kernels": an.kernels, "operators": an.ops,
        "model_flops": mf, "roofline": rl.to_dict(),
    }


def advisor_estimate(arch: str, shape_name: str, multi_pod: bool = False,
                     config=None):
    """The advisor's ``ShardPlan`` of a cell's default layout and its
    ``predict`` (a ``PlanScore``), the closed-form estimate the dry run's
    roofline is read beside."""
    from ..autosharding.advisor import ShardPlan, predict
    pc, cfg_over = default_parallel(arch, shape_name)
    cfg = dataclasses.replace(config or get_config(arch), **cfg_over)
    kv = pc.decode_kv
    if kv == "auto":
        kv = "heads" if cfg.n_kv_heads and cfg.n_kv_heads % 16 == 0 \
            else "sequence"
    plan = ShardPlan(data=16, model=16, microbatch=pc.microbatch,
                     remat=pc.remat, fsdp=True, decode_kv=kv,
                     seq_shard=pc.seq_shard)
    return plan, predict(cfg, SHAPES[shape_name], plan,
                         pods=2 if multi_pod else 1, target=TARGET)


def table(directory=None) -> list:
    """One markdown row a cell of the artifacts in ``directory`` (default
    ``ARTIFACTS``, the untagged ones): status, trace seconds, the three
    roofline terms, the bottleneck, ``roofline_frac``, ``useful_ratio``,
    the traced peak a device against the target's memory, and the
    collective term over the advisor's ``predict`` of the same layout."""
    rows = []
    for path in sorted(Path(directory or ARTIFACTS).glob("*.json")):
        art = json.loads(path.read_text())
        if path.stem != "__".join((art["arch"], art["shape"], art["mesh"])):
            continue
        head = f"| {art['arch']} | {art['shape']} | {art['mesh']} |"
        if art["status"] != "ok":
            rows.append(f"{head} {art['status'][:60]} |" + " |" * 9)
            continue
        r = art["roofline"]
        _, est = advisor_estimate(art["arch"], art["shape"],
                                  art["mesh"] == "multi")
        peak = art["memory"]["peak_bytes"]
        rows.append(
            f"{head} ok | {art['lower_s']} | {r['compute_s']:.4g} | "
            f"{r['memory_s']:.4g} | {r['collective_s']:.4g} | "
            f"{r['bottleneck']} | {r['roofline_frac']:.4g} | "
            f"{r['useful_ratio']:.4g} | {peak / 2**30:.2f} "
            f"({peak / TARGET.hbm_bytes:.2f}) | "
            f"{r['collective_s'] / est.collective_s:.3g} |")
    return rows


def sites(n: int, directory=None) -> list:
    """The ``n`` lines of the port that issue the most wire in each traced
    cell of the artifacts in ``directory`` (default ``ARTIFACTS``): one
    line a cell, each site with its share of the cell's wire."""
    rows = []
    for path in sorted(Path(directory or ARTIFACTS).glob("*.json")):
        art = json.loads(path.read_text())
        col = art.get("collectives") or {}
        total = col.get("total_wire_bytes") or 0.0
        if art.get("status") != "ok" or not total:
            continue
        top = list((col.get("wire_sites") or {}).items())[:n]
        rows.append(f"{path.stem}: {total:.4g} B; " + "; ".join(
            f"{site} {w / total:.3f}" for site, w in top))
    return rows


def cell_path(arch, shape, mesh_name, tag="") -> Path:
    sfx = f"__{tag}" if tag else ""
    return ARTIFACTS / f"{arch}__{shape}__{mesh_name}{sfx}.json"


def run_cell(arch, shape, mesh_name, skip_existing=False, overrides=None,
             tag="", device="cuda", config=None, out_dir=None,
             trips=True):
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
                         device=device, config=config, trips=trips)
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
                    help="cut the depth to N layers")
    ap.add_argument("--unrolled", action="store_true",
                    help="trace every trip (no trip counts; slow)")
    ap.add_argument("--part", type=str, default="0/1",
                    help="I/N: run every Nth cell from the Ith (the grid "
                         "in N processes)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="ParallelConfig overrides k=v")
    ap.add_argument("--table", action="store_true",
                    help="print the artifacts' table (markdown) and exit")
    ap.add_argument("--sites", type=int, default=0,
                    help="print the N lines issuing most wire a cell, exit")
    args = ap.parse_args(argv)
    if args.table:
        print("\n".join(table()))
        return
    if args.sites:
        print("\n".join(sites(args.sites)))
        return
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
    # the train cells, the slow ones, first: each part takes its share
    jobs.sort(key=lambda j: SHAPES[j[1]].kind != "train")
    i, n = map(int, args.part.split("/"))
    ok = failed = 0
    for arch, shape, m in jobs[i::n]:
        cfg = None
        if args.layers:
            cfg = dataclasses.replace(get_config(arch), n_layers=args.layers)
        tag = args.tag or "".join(
            ([f"L{args.layers}"] if args.layers else [])
            + (["unrolled"] if args.unrolled else []))
        art = run_cell(arch, shape, m, args.skip_existing,
                       overrides or None, tag, device=args.device,
                       config=cfg, trips=not args.unrolled)
        if art["status"].startswith("FAILED"):
            failed += 1
        else:
            ok += 1
    print(f"done: {ok} ok, {failed} failed")
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
