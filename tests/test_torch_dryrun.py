"""The port's 256 / 512-rank dry run (``launch.dryrun``,
``launch.dryrun_pp``) on the CPU, in subprocesses so that their fake
process groups never meet another test of the same worker (the two
slowest trip cells in a second process beside the first):

* a reduced cell of every family, for the train and decode kinds, on the
  single (16, 16) production mesh reads ``status: ok`` (train cells at 2
  microbatches in place of the layout's 8 / 16, but those of the trip
  cases below, which are these cells for their families);
* trip counts (``lower_cell``'s default): a cell counted from traces at
  fewer layers and microbatches equals the same cell traced trip by trip
  (``trips=False``) in FLOPs, both byte counts, wire by kind, by group
  and by site, collectives, kernel calls, launches, FLOPs and bytes,
  operators and the inputs' bytes (relative 1e-9), and its traced peak
  is within 1%: train cells of the dense, moe (MLA), hybrid and encdec
  families at 4 layers in remat groups of 1 (whisper's two stacks
  apart), the dense and moe ones at 4 microbatches (extrapolated from 2
  and 3), the hybrid and encdec ones at 2 (traced as they are), decode
  cells of the vlm and ssm families and a prefill cell at 4 layers (a
  stack is traced at 2 and 3 layers: its first layer holds a smaller
  peak than the later ones); ``extrapolate`` refuses a count that does
  not come out whole;
* the dense train cell runs Megatron sequence parallelism (``seq_tp``);
  a prefill cell, a ``long_500k`` cell of a sub-quadratic arch and a train
  cell on the (2, 16, 16) multi-pod mesh read ``ok``, the multi-pod cell's
  attention at half the single-pod cell's FLOPs a device and layer (the
  pod axis doubles the data-parallel ranks over the same global batch);
  a ``long_500k`` cell of a full-attention arch is recorded as skipped;
* layouts: a train step's microbatches split each rank's own rows (no
  wire issued from the split),
  and an MLA decode step over its sequence-sharded latent cache attends
  by flash-decoding on each rank's block (no kernel call without the
  log-sum-exp, less wire than the cache's bytes);
* the artifact has the reference's keys (``lower_cell``'s and the
  roofline's), and ``run_cell`` writes it, recording a failing cell as
  ``FAILED: ...`` with its traceback;
* every parameter of every full-size config, laid out on the production
  mesh (metadata only), has the local shape of its global shape over its
  mesh extents;
* FSDP: a projection whose weight is sharded over (data, model) traces
  one all-gather of the weight over the 16-way data axis, its wire the
  ring value (the gathered bytes x 15 / 16);
* the reduced pipelined cell (``dryrun_pp``, 4 stages x 8 microbatches)
  reads ``bubble_frac = 3/11`` and a collective-permute wire of one hop a
  tick.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2-1.8b", "qwen2-vl-72b", "deepseek-v2-236b",
         "grok-1-314b", "falcon-mamba-7b", "hymba-1.5b", "whisper-tiny")
# trip-count cases: (layers, overrides) of each reduced cell, in remat
# groups of 1.  The dense and moe cells extrapolate 4 microbatches from 2
# and 3; the hybrid and encdec ones, slower to trace (whisper's two
# stacks take 4 traces, 8 with the microbatches), keep 2 traced as they
# are, to keep the file's time
TRIP_CELLS = {
    "internlm2-1.8b/train_4k": (4, {"remat_group": 1, "microbatch": 4}),
    "deepseek-v2-236b/train_4k": (4, {"remat_group": 1, "microbatch": 4}),
    "hymba-1.5b/train_4k": (4, {"remat_group": 1, "microbatch": 2}),
    "whisper-tiny/train_4k": (4, {"remat_group": 1, "microbatch": 2}),
    "qwen2-vl-72b/decode_32k": (4, None),
    "falcon-mamba-7b/decode_32k": (4, None),
    "qwen2-72b/prefill_32k": (4, None),
}

PROGRAM = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs import ALIASES, ARCH_IDS, get_config, get_reduced
    from repro_torch.launch import dryrun as D, graph_analysis as G
    from repro_torch.launch.dryrun_pp import DATA, MICRO, STAGES, pp_cell
    from repro_torch.models.config import SHAPES
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import layers as Ly
    from repro_torch.models.config import ParallelConfig
    from repro_torch.launch.specs import input_specs, params_specs
    from torch.utils._pytree import tree_leaves
    from repro_torch.parallel import sharding as Sh

    out, archs, art_dir = {}, json.loads(sys.argv[1]), sys.argv[2]
    # the trip cells this process traces, every trip cell's key, and
    # whether it runs the other cases
    trip_cells, trip_keys = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    rest = sys.argv[5] == "rest"

    def reduced(arch, layers=None):
        cfg = get_reduced(arch)
        if layers is None:
            return cfg
        depth = {"n_layers": layers}
        if cfg.family == "encdec":
            depth["enc_layers"] = layers
        return dataclasses.replace(cfg, **depth)

    def summary(art):
        keep = {k: art.get(k) for k in (
            "status", "traceback", "n_chips", "flops_per_device",
            "bytes_per_device", "bytes_all_per_device", "lower_s",
            "collectives", "kernels", "operators", "memory", "parallel",
            "trips")}
        keep["keys"] = sorted(art)
        keep["roofline_keys"] = sorted(art.get("roofline") or {})
        return keep

    # trip counts against every trip traced: these cells stand for their
    # families' reduced cells below
    for key, (layers, over) in trip_cells.items():
        arch, shape = key.split("/")
        out[f"trips/{key}"] = {
            how: summary(D.lower_cell(ALIASES[arch], shape, False,
                                      overrides=over, device="cpu",
                                      config=reduced(arch, layers),
                                      trips=trips))
            for how, trips in (("trips", True), ("unrolled", False))}
        out[key] = out[f"trips/{key}"]["trips"]
    if not rest:
        print("RESULT " + json.dumps(out, default=float))
        sys.exit(0)
    for arch in archs:
        for shape in ("decode_32k", "train_4k"):
            if f"{arch}/{shape}" in trip_keys:
                continue
            art = D.run_cell(ALIASES[arch], shape, "single",
                             overrides={"microbatch": 2}, device="cpu",
                             config=get_reduced(arch), out_dir=art_dir)
            out[f"{arch}/{shape}"] = summary(art)
    # the dense train cell on the multi-pod mesh in the single-pod trip
    # cell's layout, at 2 layers and 2 microbatches (traced as they are)
    out["multi/train_4k"] = summary(D.lower_cell(
        "internlm2_1_8b", "train_4k", True, device="cpu",
        overrides={"remat_group": 1, "microbatch": 2},
        config=reduced("internlm2-1.8b", 2), trips=False))
    # one rank's share of the MLA latent cache
    out["mla_cache_bytes_per_device"] = sum(
        t.numel() * t.element_size() for t in tree_leaves(input_specs(
            "deepseek_v2_236b", "decode_32k",
            get_reduced("deepseek-v2-236b"))["cache"])) / 256
    out["long_500k"] = summary(D.lower_cell(
        "falcon_mamba_7b", "long_500k", False, device="cpu",
        config=reduced("falcon-mamba-7b")))
    out["long_500k_full_attention"] = D.lower_cell(
        "qwen2_72b", "long_500k", False, device="cpu",
        config=reduced("qwen2-72b"))
    # 3 microbatches do not split the batch: the cell fails
    bad = D.run_cell("qwen2_72b", "train_4k", "single", device="cpu",
                     overrides={"microbatch": 3},
                     config=get_reduced("qwen2-72b"), out_dir=art_dir,
                     tag="bad")
    out["bad"] = {"status": bad["status"], "tb": bool(bad.get("traceback"))}

    with fake_world(512):
        mesh = make_production_mesh(device="cpu")
        rules = Sh.make_rules(ParallelConfig())
        local = {}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            mod = params_specs(cfg)
            specs = Sh.param_specs(mod, cfg, mesh, rules)
            Sh.distribute_module(mod, cfg, mesh, rules)
            ok = 0
            for n, p in mod.named_parameters():
                want = [d // Sh._axis_size({"data": 16, "model": 16}, ax)
                        for d, ax in zip(p.shape, specs[n])]
                assert list(p.to_local().shape) == want, (arch, n)
                ok += 1
            local[arch] = ok
        out["local"] = local

        # FSDP: x (B over data) @ w ((d_in over data) x (d_out over model))
        B, din, dout = 4096, 256, 512
        w = Ly.Dense(din, dout, device="meta")
        w.w.requires_grad_(True)
        x = Sh.distribute(torch.empty(B, din, device="meta"), mesh,
                          Sh.placements(Sh.P("data", None), mesh))
        w.w = torch.nn.Parameter(Sh.distribute(
            w.w.detach(), mesh, Sh.placements(Sh.P("data", "model"), mesh)),
            requires_grad=True)

        def step(p, xs):
            Ly.dense(p, xs).sum().backward()
        an = G.analyze(step, w, x, device="cpu")
        out["fsdp"] = {"wire": an.wire_bytes, "counts": an.collectives,
                       "ring": din * (dout // 16) * 4 * 15 / 16,
                       "groups": [[list(r), w]
                                  for r, w in an.group_wire.items()]}

    cfg = dataclasses.replace(get_reduced("qwen2-72b"), n_layers=4)
    pp = pp_cell(cfg, device="cpu")
    out["pp"] = {k: pp[k] for k in ("bubble_frac", "collective_permute_wire",
                                    "status", "microbatches")}
    out["pp"]["keys"] = sorted(pp)
    # stage 0 sends its (data-local) microbatch activation once a tick
    sc = SHAPES["train_4k"]
    out["pp"]["hop"] = (MICRO + STAGES - 1) * (sc.global_batch // MICRO
                                               // DATA) \\
        * sc.seq_len * cfg.d_model * 2
    print("RESULT " + json.dumps(out, default=float))
""")


# the slowest trip cells trace in a second process beside the first
APART = ("whisper-tiny/train_4k", "deepseek-v2-236b/train_4k")


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    art_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for apart in (True, False):
        logs = [art_dir / f"{apart}.{k}" for k in ("out", "err")]
        with open(logs[0], "w") as fo, open(logs[1], "w") as fe:
            runs.append((subprocess.Popen(
                [sys.executable, "-c", PROGRAM, json.dumps(ARCHS),
                 str(art_dir), json.dumps({k: v for k, v in TRIP_CELLS.items()
                                           if (k in APART) == apart}),
                 json.dumps(sorted(TRIP_CELLS)), "" if apart else "rest"],
                env=env, stdout=fo, stderr=fe), logs))
    out = {"dir": art_dir}
    try:
        for p, (o, e) in runs:
            assert p.wait(timeout=900) == 0, e.read_text()[-4000:]
            line = [ln for ln in o.read_text().splitlines()
                    if ln.startswith("RESULT ")]
            out.update(json.loads(line[-1][7:]))
    finally:
        for p, _ in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cell_of_every_family_is_ok(result, arch, shape):
    cell = result[f"{arch}/{shape}"]
    assert cell["status"] == "ok", cell["traceback"]
    assert cell["n_chips"] == 256 and cell["flops_per_device"] > 0


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _same_sums(got, want, path=""):
    """Every number of ``want`` (a nested dict of counts) in ``got``
    within relative 1e-9; a key either side lacks reads 0."""
    if isinstance(want, dict) or isinstance(got, dict):
        for k in set(got or {}) | set(want or {}):
            _same_sums((got or {}).get(k, 0), (want or {}).get(k, 0),
                       f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_sums(g, w, f"{path}[{i}]")
    else:
        assert _rel(got, want) <= 1e-9, (path, got, want)


@pytest.mark.parametrize("cell", sorted(TRIP_CELLS))
def test_trip_counts_equal_every_trip_traced(result, cell):
    t, u = (result[f"trips/{cell}"][k] for k in ("trips", "unrolled"))
    assert t["status"] == u["status"] == "ok", (t["traceback"],
                                               u["traceback"])
    layers, over = TRIP_CELLS[cell]
    M = (over or {}).get("microbatch")
    # fewer trips were traced than the cell has; the unrolled one has all
    assert t["trips"]["traces"] > 1 and u["trips"]["traces"] == 1
    depths = {k: v for k, v in t["trips"]["traced"].items()
              if k != "microbatch"}
    assert all(max(v) < layers for v in depths.values())
    assert set(t["trips"]["extrapolated_to"].values()) <= {layers, M}
    if M and M > 3:
        assert t["trips"]["traced"]["microbatch"] == [2, 3]
    for k in ("flops_per_device", "bytes_per_device", "bytes_all_per_device",
              "operators", "kernels"):
        _same_sums(t[k], u[k], k)
    for k in ("wire_bytes", "counts", "group_wire", "inter_node_wire_bytes",
              "wire_sites"):
        _same_sums(t["collectives"][k], u["collectives"][k], k)
    _same_sums(t["memory"]["argument_size_in_bytes"],
               u["memory"]["argument_size_in_bytes"], "inputs")
    assert _rel(t["memory"]["peak_bytes"], u["memory"]["peak_bytes"]) <= 0.01
    assert u["kernels"], "the cell traced no kernel operator"


def test_dense_train_cell_runs_sequence_parallelism(result):
    cell = result["internlm2-1.8b/train_4k"]
    assert cell["status"] == "ok" and cell["parallel"]["seq_tp"] is True


def test_prefill_long_and_multi_pod_cells(result):
    assert result["qwen2-72b/prefill_32k"]["status"] == "ok"
    long = result["long_500k"]
    assert long["status"] == "ok", long["traceback"]
    assert long["parallel"]["seq_shard"] is True and long["kernels"]
    multi = result["multi/train_4k"]
    single = result["trips/internlm2-1.8b/train_4k"]["unrolled"]
    assert multi["status"] == "ok", multi["traceback"]
    assert multi["n_chips"] == 512 and single["n_chips"] == 256
    # 2 layers x 2 microbatches against the single-pod cell's 4 x 4: the
    # attention operators' calls scale with layers x microbatches, their
    # FLOPs with the layers (the microbatches split one batch)
    for op in ("repro_torch::flash_attention_fwd_lse",
               "repro_torch::flash_attention_bwd"):
        assert multi["kernels"][op]["calls"] * (4 * 4) // (2 * 2) == \
            single["kernels"][op]["calls"]
        assert multi["kernels"][op]["flops"] * (4 / 2) == \
            single["kernels"][op]["flops"] / 2


def test_microbatches_split_each_ranks_own_rows(result):
    # slicing the batch-sharded batch would gather it from ``_split``
    # (the vlm cell's patch embeddings, the encdec cell's audio)
    for arch in ("qwen2-vl-72b", "whisper-tiny", "internlm2-1.8b"):
        cell = result[f"{arch}/train_4k"]
        sites = cell["collectives"]["wire_sites"]
        assert sites and not [s for s in sites if s.endswith(" _split")]


def test_mla_decode_attends_on_each_ranks_cache_block(result):
    cell = result["deepseek-v2-236b/decode_32k"]
    assert cell["status"] == "ok", cell["traceback"]
    kernels = cell["kernels"]
    assert set(kernels) == {"repro_torch::flash_attention_fwd_lse"}
    assert kernels["repro_torch::flash_attention_fwd_lse"]["calls"] == 2
    assert cell["collectives"]["total_wire_bytes"] < \
        result["mla_cache_bytes_per_device"]


def test_extrapolate_refuses_a_count_that_is_not_whole():
    from repro_torch.launch import graph_analysis as G

    def an(ops):
        return G.StepAnalysis(
            flops=0.0, flops_kernels=0.0, bytes_all=0.0, bytes_heavy=0.0,
            wire_bytes={}, collectives={}, total_wire_bytes=0.0,
            group_wire={}, wire_sites={}, peak_bytes=0, input_bytes=0,
            kernels={}, ops=ops)
    # 3 layers between corners at 2 and 4: half of an odd difference
    assert G.extrapolate({(2,): an(10), (4,): an(20)}, (2,), (4,),
                         (3,)).ops == 15
    with pytest.raises(ValueError, match="whole"):
        G.extrapolate({(2,): an(10), (4,): an(21)}, (2,), (4,), (3,))


def test_long_cell_of_full_attention_is_skipped(result):
    art = result["long_500k_full_attention"]
    assert art["status"] == "skipped (full attention)"
    assert art["shape"] == "long_500k" and art["mesh"] == "single"


REF_KEYS = {"arch", "shape", "mesh", "status", "n_chips", "parallel",
            "lower_s", "compile_s", "flops_per_device", "bytes_per_device",
            "xla_cost_analysis", "memory", "collectives", "model_flops",
            "roofline"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s",
                 "flops_per_device", "bytes_per_device",
                 "wire_bytes_per_device", "model_flops", "hlo_total_flops",
                 "useful_ratio", "bottleneck", "step_time_s",
                 "roofline_frac"}


def test_artifact_has_the_reference_keys(result):
    import repro.launch.hlo_analysis as H
    assert ROOFLINE_KEYS == set(H.Roofline.__dataclass_fields__)
    for arch in ARCHS:
        cell = result[f"{arch}/train_4k"]
        assert REF_KEYS <= set(cell["keys"])
        assert set(cell["roofline_keys"]) == ROOFLINE_KEYS
    art = json.loads((result["dir"] /
                      "internlm2_1_8b__decode_32k__single.json").read_text())
    assert art["compile_s"] is None and art["xla_cost_analysis"] is None
    assert art["memory"]["peak_bytes"] >= art["memory"][
        "argument_size_in_bytes"] > 0
    assert result["bad"]["status"].startswith("FAILED: ")
    assert result["bad"]["tb"]


def test_local_shapes_are_global_over_mesh_extents(result):
    from repro_torch.configs import ARCH_IDS
    assert set(result["local"]) == set(ARCH_IDS)
    assert all(n > 0 for n in result["local"].values())


def test_fsdp_all_gather_wire_is_the_ring_value(result):
    f = result["fsdp"]
    assert f["counts"]["all-gather"] == 1
    assert f["wire"]["all-gather"] == f["ring"]
    # the wire is also recorded by group: rank 0's data group, ranks 16
    # apart on the (16, 16) mesh, which spans 16 nodes of 8
    assert [r for r, _ in f["groups"]] == [list(range(0, 256, 16))]
    assert f["groups"][0][1] == sum(f["wire"].values())


def test_pipelined_cell_bubble_and_hops(result):
    pp = result["pp"]
    assert pp["status"] == "ok" and pp["microbatches"] == 8
    assert pp["bubble_frac"] == 3 / 11
    assert pp["collective_permute_wire"] == pp["hop"]
    assert {"bubble_frac", "flops_per_device", "collective_permute_wire",
            "memory", "compile_s", "mesh", "name"} <= set(pp["keys"])
