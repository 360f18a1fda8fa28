"""The port's 256 / 512-rank dry run (``launch.dryrun``,
``launch.dryrun_pp``) on the CPU, in one subprocess so that its fake
process group never meets another test of the same worker:

* a reduced cell of every family, for the train and decode kinds, on the
  single (16, 16) production mesh reads ``status: ok`` (train cells at 2
  microbatches in place of the layout's 8 / 16: the trace unrolls them);
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
    from repro_torch.launch.specs import params_specs
    from repro_torch.parallel import sharding as Sh

    out, archs, art_dir = {}, json.loads(sys.argv[1]), sys.argv[2]
    for arch in archs:
        for shape in ("decode_32k", "train_4k"):
            art = D.run_cell(ALIASES[arch], shape, "single",
                             overrides={"microbatch": 2}, device="cpu",
                             config=get_reduced(arch), out_dir=art_dir)
            out[f"{arch}/{shape}"] = {k: art.get(k) for k in (
                "status", "traceback", "n_chips", "flops_per_device",
                "lower_s")}
            out[f"{arch}/{shape}"]["keys"] = sorted(art)
            out[f"{arch}/{shape}"]["roofline_keys"] = sorted(
                art.get("roofline") or {})
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


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    art_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", PROGRAM, json.dumps(ARCHS),
                        str(art_dir)], env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return dict(json.loads(line[-1][7:]), dir=art_dir)


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cell_of_every_family_is_ok(result, arch, shape):
    cell = result[f"{arch}/{shape}"]
    assert cell["status"] == "ok", cell["traceback"]
    assert cell["n_chips"] == 256 and cell["flops_per_device"] > 0


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
