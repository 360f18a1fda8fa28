"""The port's sharding rules (``parallel.sharding``), activation-sharding
resolution (``parallel.ctx``) and the H100 target's two fabric tiers,
against the reference:

* ``param_spec`` equals the reference's for every parameter of every
  config, on the (16, 16) and (2, 16, 16) production meshes (stand-ins
  with only ``.shape``, as the reference's own tests use), the leading
  ``None`` of the reference's stacked layer leaves dropped;
* ``batch_spec`` and ``cache_spec`` equal the reference's for every
  family, shape kind and decode-cache mode;
* ``ctx.resolve`` equals the reference's ``shard`` resolution on the same
  shapes and logical dims (the reference's spec read through a
  recording ``with_sharding_constraint``);
* ``placements`` turns a dim over ("pod", "data") into ``Shard`` on both
  mesh dims in mesh order;
* two fabric tiers: ``node_gpus`` at least the mesh size gives the
  one-fabric numbers (the reference's), the default 8-GPU node prices the
  groups that leave the node at ``net_gbps``.
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

import repro.parallel.ctx as ref_ctx
from repro.autosharding import advisor as ref_adv
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.config import ParallelConfig as RefPC
from repro.parallel import sharding as ref_sh

from repro_torch.autosharding import advisor as adv
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.constants import DEFAULT_H100
from repro_torch.launch import graph_analysis as G
from repro_torch.launch.specs import params_specs
from repro_torch.models.config import SHAPES, ParallelConfig
from repro_torch.parallel import ctx, sharding as Sh

STACKED = ("blocks", "encoder", "decoder")


class _Mesh:
    """A production mesh's named extents (all the rules read)."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"single": _Mesh(data=16, model=16),
          "multi": _Mesh(pod=2, data=16, model=16)}


def _ref_specs(cfg, mesh):
    tree = ref_specs.params_specs(cfg)
    rules = ref_sh.make_rules(RefPC())
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
        spec = tuple(ref_sh.param_spec(path, leaf, cfg, mesh, rules))
        if names[0] in STACKED:
            assert spec[0] is None
            spec = spec[1:]
        out[".".join(names)] = spec
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_matches_reference(arch, mesh):
    m = MESHES[mesh]
    want = _ref_specs(ref_get_config(arch), m)
    cfg = get_config(arch)
    got = Sh.param_specs(params_specs(cfg), cfg, m,
                         Sh.make_rules(ParallelConfig()))
    seen = set()
    for name, spec in got.items():
        key = ".".join(n for n in name.split(".") if not n.isdigit())
        assert tuple(spec) == want[key], name
        seen.add(key)
    assert seen == set(want)


KV_MODES = ("auto", "heads", "sequence")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in SHAPES.values():
        for seq_shard in (False, True):
            pc = ParallelConfig(seq_shard=seq_shard)
            rpc = RefPC(seq_shard=seq_shard)
            for B in (shape.global_batch, 1, 3):
                got = Sh.batch_spec(cfg, pc, m, B, shape.seq_len)
                want = ref_sh.batch_spec(ref_cfg, rpc, m, B, shape.seq_len)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}
    for mode in KV_MODES:
        for B in (128, 1):
            got = Sh.cache_spec(cfg, ParallelConfig(decode_kv=mode), m, B)
            want = ref_sh.cache_spec(ref_cfg, RefPC(decode_kv=mode), m, B)
            assert _as_tuples(got) == _as_tuples(want)


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, jax.sharding.PartitionSpec) or isinstance(tree,
                                                                 Sh.P):
        return ("spec", tuple(tree))
    return tuple(_as_tuples(v) for v in tree)


DIMS = [("batch", "seq", None), ("batch", "seq", "heads", None),
        ("batch", None, None, None), ("batch", "seq", "tp"),
        ("ep", None, "tp"), ("ep", None, None), ("cap", "heads", None),
        ("seq", "batch", None), (None, "tp")]
SHAPES_ = [(256, 4096, 8192), (256, 4096, 64, 128), (16, 1, 8, 128),
           (256, 4096, 29568), (160, 512, 1536), (8, 4096, 6144),
           (32, 48, 7), (4096, 6, 384), (12, 32)]
PCS = [dict(), dict(seq_shard=True), dict(seq_tp=True),
       dict(seq_tp=True, seq_shard=True), dict(tensor_axis="none")]


def _ref_resolve(mesh, pc, shape, dims):
    """The reference's ``shard`` spec for a tensor of ``shape``, read
    through a recording ``with_sharding_constraint``."""
    seen = []
    x = jax.ShapeDtypeStruct(shape, np.float32)
    with mock.patch.object(ref_ctx.jax.lax, "with_sharding_constraint",
                           lambda v, s: seen.append(tuple(s.spec))), \
            mock.patch.object(ref_ctx, "NamedSharding",
                              lambda m, s: SimpleNamespace(spec=s)):
        with ref_ctx.activation_sharding(mesh, RefPC(**pc)):
            ref_ctx.shard(x, dims)
    return seen[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ctx_resolution_matches_reference(mesh):
    m = MESHES[mesh]
    for pc in PCS:
        with ctx.activation_sharding(m, ParallelConfig(**pc)):
            for shape, dims in zip(SHAPES_, DIMS):
                got = tuple(ctx.resolve(shape, dims))
                assert got == _ref_resolve(m, pc, shape, dims), (pc, dims)
    assert not ctx.active()


def test_placements_follow_mesh_order():
    m = _Mesh(pod=2, data=16, model=16)
    assert Sh.placements(Sh.P(("pod", "data"), "model"), m) == (
        Shard(0), Shard(0), Shard(1))
    assert Sh.placements(Sh.P("model", None), m) == (
        Replicate(), Replicate(), Shard(0))
    assert Sh.placements(Sh.P(None, None), MESHES["single"]) == (
        Replicate(), Replicate())


def test_one_node_as_large_as_the_mesh_prices_one_fabric():
    """``node_gpus`` at the mesh size: the reference's one-fabric numbers
    for every plan of a cell; at the default 8-GPU node the collective
    term only grows, and a plan inside one node is unchanged."""
    tpu = ref_adv.DEFAULT_TPU
    one = dataclasses.replace(
        DEFAULT_H100, peak_bf16_tflops=tpu.peak_bf16_tflops,
        hbm_gbps=tpu.hbm_gbps, link_gbps=tpu.ici_link_gbps,
        links_per_chip=tpu.ici_links_per_chip, hbm_bytes=tpu.hbm_bytes,
        node_gpus=256)
    nodes = dataclasses.replace(one, node_gpus=8)
    for arch, shape in (("qwen2_72b", "train_4k"),
                        ("deepseek_v2_236b", "decode_32k")):
        cfg, sc = get_config(arch), SHAPES[shape]
        rcfg = ref_get_config(arch)
        for p in adv.plan_space(256, train=(sc.kind == "train")):
            got = adv.predict(cfg, sc, p, target=one)
            want = ref_adv.predict(rcfg, REF_SHAPES[shape],
                                   ref_adv.ShardPlan(**dataclasses.asdict(p)))
            np.testing.assert_allclose(got.collective_s, want.collective_s,
                                       rtol=1e-12)
            tiered = adv.predict(cfg, sc, p, target=nodes)
            assert tiered.collective_s >= got.collective_s
            if p.model * p.data * p.pipeline_stages <= 8:
                assert tiered.collective_s == got.collective_s
    # wire by group: 3e9 inside ranks 0-7, 1e9 over ranks 0-15
    groups = {tuple(range(8)): 3e9, tuple(range(16)): 1e9}
    r_one = G.roofline(1e12, 1e9, 4e9, 256, 1e14, target=one,
                       group_wire=groups)
    r_net = G.roofline(1e12, 1e9, 4e9, 256, 1e14, target=nodes,
                       group_wire=groups)
    link = one.links_per_chip * one.link_gbps * 1e9
    assert r_one.collective_s == 4e9 / link
    assert r_net.collective_s == pytest.approx(3e9 / link + 1e9 / 50e9)
    assert G.inter_node_wire(groups, 8) == 1e9
    assert G.inter_node_wire(groups, 16) == 0.0


def test_h100_node_numbers():
    assert DEFAULT_H100.node_gpus == 8
    assert DEFAULT_H100.net_gbps == 50.0        # 400 Gb/s a GPU


def test_flat_mesh_places_the_flattened_axes_as_one_dim():
    """On a ``FlatMesh`` whose first dim holds ("pod", "data") a dimension
    over both axes is one ``Shard`` of that dim (the blocks the two
    ``Shard``s of the three-dim mesh give the same ranks); a spec naming
    "data" alone cannot be laid out on it."""
    from repro_torch.parallel import sharding as Sh
    flat = Sh.FlatMesh(None, ((("pod", 2), ("data", 16)), (("model", 16),)))
    three = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
    assert Sh.mesh_shape(flat) == three.shape
    spec = Sh.P(("pod", "data"), "model")
    assert Sh.placements(spec, flat) == (Shard(0), Shard(1))
    assert Sh.placements(spec, three) == (Shard(0), Shard(0), Shard(1))
    assert Sh.placements(Sh.P(None, "model"), flat) == (Replicate(),
                                                       Shard(1))
    with pytest.raises(ValueError, match="flattened"):
        Sh.placements(Sh.P("data", None), flat)


def test_production_mesh_needs_its_world():
    """Without a process group of 256 ranks the production mesh raises the
    reference's error, pointing at the dry run."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="dryrun"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="dryrun"):
        make_production_mesh(multi_pod=True, device="cpu")
