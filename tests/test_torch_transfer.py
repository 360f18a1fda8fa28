"""Cross-workload transfer on the port (``repro_torch``), case for case the
reference's ``tests/test_transfer.py``: workload identity and feature
embeddings, the portable design IR (``to_portable`` / ``migrate`` /
``repair``), the archive manifest (nearest-neighbor index, crash-safe
persistence, growth policy, trust table), the service's ``transfer=True``
path, and transferred seed designs in the scalarized engine.

Where a piece is deterministic the port is also held to the reference on
the same numpy inputs: ``repair``, ``migrate``, ``portable_signature`` and
``space_digest`` exactly; manifest ``nearest`` / ``dedup`` and the trust fit
at 1e-12.  The searches run only on the port (pop 8, a generation or two).
"""

import numpy as np
import pytest
import torch

from repro.core import SystemSpec as RefSpec, DesignSpace as RefSpace
from repro.core import encoding as ref_enc
from repro.core import presets as ref_presets
from repro.core import workload as ref_wl
from repro.explore import archive as ref_arc

from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as P
from repro_torch.core import workload as W
from repro_torch.core.encoding import (DesignSpace, PortableDesign,
                                       SpaceDigest, feasibility_penalty,
                                       from_portable, migrate,
                                       portable_signature, random_design,
                                       repair, space_digest, to_portable)
from repro_torch.core.evaluate import SystemSpec
from repro_torch.core.network import N_FAMILIES
from repro_torch.core.optimizer import SAConfig
from repro_torch.core.workload import (MAX_LOOPS, WL_EMBED_DIM,
                                       WL_FEATURE_DIM, embedding_delta,
                                       graph_feature_rows, workload_features,
                                       workload_signature)
from repro_torch.explore.archive import (MANIFEST_NAME, ArchiveManifest,
                                         ManifestPolicy, ParetoArchive,
                                         TrustModel, atomic_savez,
                                         fit_trust_model)
from repro_torch.explore.nsga import NSGAConfig
from repro_torch.explore.service import ExplorationService

# the service cases exercise the deprecated explore() shim on purpose, so
# they read one for one with the reference's
pytestmark = pytest.mark.filterwarnings("ignore:legacy entry point")

TINY_SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")


def _tiny_graph(k=64, mod=W):
    return mod.WorkloadGraph([mod.matmul("mm", 512, 512, k)], [])


def _space(graph, ch_max=2, **kw):
    spec = SystemSpec.build(graph, ch_max=ch_max)
    return spec, DesignSpace(spec, **(kw or TINY_SPACE_KW))


def _ref_space(graph, ch_max=2, **kw):
    spec = RefSpec.build(graph, ch_max=ch_max)
    return RefSpace(spec, **(kw or TINY_SPACE_KW))


def _raw_design(space, seed=0):
    return {k: v.numpy() for k, v in
            random_design(seed, space, device="cpu").items()}


def _repaired_design(space, seed=0):
    return repair(_raw_design(space, seed), space)


def _svc(path, **kw):
    kw.setdefault("nsga", NSGAConfig(pop=8, generations=2))
    return ExplorationService(cache_dir=path, device="cpu", **kw)


def assert_same_design(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def assert_design_valid(d, space):
    """Every field inside its legal range for ``space``."""
    dg = space_digest(space) if not isinstance(space, SpaceDigest) else space
    Wn, CH, L = dg.W, dg.CH, MAX_LOOPS
    mx = np.asarray(dg.max_shape)
    nl = np.maximum(np.asarray(dg.n_loops), 1)
    sh = np.asarray(d["shape"])
    assert sh.shape == (Wn, 6) and sh.min() >= 1 and np.all(sh <= mx[None])
    sp = np.asarray(d["spatial"])
    assert np.all(sp >= 0) and np.all(sp < nl[:, None])
    for row in np.asarray(d["order"]).reshape(Wn * 3, L):
        assert sorted(row.tolist()) == list(range(L))
    tl = np.asarray(d["tiling"])
    assert tl.min() >= 1 and np.all(tl <= np.asarray(dg.bounds)[:, None, :])
    pipe = np.asarray(d["pipe"])
    assert np.all((pipe == L) | ((pipe >= 0) & (pipe < nl)))
    assert 0 <= int(np.asarray(d["logB"])) <= dg.max_logB
    assert 0 <= int(np.asarray(d["packaging"])) <= 2
    assert 0 <= int(np.asarray(d["family"])) < N_FAMILIES
    assert sorted(np.asarray(d["placement"]).tolist()) == list(range(Wn * CH))


def assert_design_feasible(d, space):
    """Valid AND zero feasibility penalty (chiplet count / PE budget)."""
    assert_design_valid(d, space)
    pen = float(feasibility_penalty(
        space, {k: torch.as_tensor(np.asarray(v))[None]
                for k, v in d.items()})[0])
    assert pen == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# workload identity + feature embeddings
# ---------------------------------------------------------------------------
def test_workload_signature_is_structural():
    a = W.matmul("first", 64, 64, 64)
    b = W.matmul("second", 64, 64, 64)       # same structure, other name
    c = W.matmul("first", 64, 64, 128)       # other bounds
    assert workload_signature(a) == workload_signature(b)
    assert workload_signature(a) != workload_signature(c)
    assert workload_signature(a) != workload_signature(
        W.conv2d("x", 1, 64, 64, 8, 8, 3, 3))
    # the reference hashes the same structure to the same signature
    assert workload_signature(c) == ref_wl.workload_signature(
        ref_wl.matmul("first", 64, 64, 128))


def test_feature_rows_and_embedding_dims():
    g = P.transformer_block()
    rows = graph_feature_rows(g)
    assert rows.shape == (g.n, WL_FEATURE_DIM)
    emb = workload_features(g)
    assert emb.shape == (WL_EMBED_DIM,)
    assert np.all(np.isfinite(emb))
    assert workload_features(_tiny_graph()).shape == (WL_EMBED_DIM,)
    np.testing.assert_array_equal(
        emb, ref_wl.workload_features(ref_presets.transformer_block()))


def test_embedding_similarity_ranks_library_families():
    lib = P.workload_library()
    emb = {k: workload_features(g) for k, g in lib.items()}
    d = lambda a, b: float(np.linalg.norm(emb[a] - emb[b]))
    assert d("attn_qwen2_72b", "attn_qwen2_5_32b") \
        < d("attn_qwen2_72b", "conv_whisper")
    assert d("mlp_qwen2_72b", "mlp_deepseek_v2") \
        < d("mlp_qwen2_72b", "conv_whisper")


def test_workload_library_is_diverse_and_buildable():
    lib = P.workload_library()
    ref_lib = ref_presets.workload_library()
    assert list(lib) == list(ref_lib)
    sigs = set()
    for name, g in lib.items():
        spec = SystemSpec.build(g, ch_max=2)     # validates padding limits
        assert spec.W == g.n and g.depth() >= 2
        g.topo_order()                           # acyclic
        sig = tuple(workload_signature(w) for w in g.workloads)
        sigs.add(sig)
        assert sig == tuple(ref_wl.workload_signature(w)
                            for w in ref_lib[name].workloads)
    assert len(sigs) == len(lib) >= 8            # no duplicate graphs


# ---------------------------------------------------------------------------
# portable design IR
# ---------------------------------------------------------------------------
def test_space_digest_json_roundtrip():
    _, space = _space(P.transformer_block())
    dg = space_digest(space)
    back = SpaceDigest.from_dict(dg.to_json_dict())
    assert back.signatures == dg.signatures
    assert back.W == dg.W and back.CH == dg.CH
    np.testing.assert_allclose(back.features, dg.features)
    np.testing.assert_array_equal(back.bounds, dg.bounds)
    assert back.max_shape == dg.max_shape
    d = _repaired_design(space, seed=1)
    via_dict = migrate(d, dg.to_json_dict(), dg.to_json_dict())
    assert_same_design(via_dict, d)
    # the JSON form is the reference's, value for value
    ref = ref_enc.space_digest(_ref_space(ref_presets.transformer_block()))
    assert dg.to_json_dict() == ref.to_json_dict()


def test_repair_fixes_arbitrary_garbage():
    _, space = _space(_tiny_graph())
    Wn, CH, L = space.W, space.CH, MAX_LOOPS
    garbage = dict(
        shape=np.full((Wn, 6), 99, np.int64),
        spatial=np.full((Wn, 6), -3, np.int64),
        order=np.zeros((Wn, 3, L), np.int64),          # not a permutation
        tiling=np.full((Wn, 2, L), 10**9, np.int64),
        pipe=np.full((Wn,), 5, np.int64),              # >= n_loops (3)
        logB=np.asarray(99),
        packaging=np.asarray(-7),
        family=np.asarray(99),
        placement=np.zeros((Wn * CH,), np.int64))      # duplicate entries
    fixed = repair(garbage, space)
    assert_design_feasible(fixed, space)
    assert_same_design(repair(fixed, space), fixed)   # idempotent
    assert_same_design(fixed, ref_enc.repair(
        garbage, _ref_space(_tiny_graph(mod=ref_wl))))
    # tensors are accepted as well as numpy
    assert_same_design(repair({k: torch.as_tensor(v)
                               for k, v in garbage.items()}, space), fixed)


def test_repair_respects_fixed_fields_and_pe_budget():
    spec, _ = _space(_tiny_graph())
    kw = dict(max_shape=(16, 16, 4, 4, 2, 2), fixed_packaging=2,
              fixed_family=1, max_total_pes=512, allow_pipeline=False)
    space = DesignSpace(spec, **kw)
    raw = _raw_design(space, seed=9)
    d = repair(raw, space)
    assert int(d["packaging"]) == 2 and int(d["family"]) == 1
    assert int(d["logB"]) == 0 and np.all(d["pipe"] == MAX_LOOPS)
    assert int(np.prod(d["shape"], axis=1).sum()) <= 512
    assert_design_feasible(d, space)
    assert_same_design(d, ref_enc.repair(
        raw, _ref_space(_tiny_graph(mod=ref_wl), **kw)))


def _superset(mod, presets_mod):
    gA = presets_mod.transformer_block()
    gB = mod.WorkloadGraph(list(gA.workloads)
                           + [mod.matmul("extra", 128, 128, 128)],
                           list(gA.edges))
    return gA, gB


def test_migrate_roundtrip_through_superset_space():
    gA, gB = _superset(W, P)
    big = dict(max_shape=(16, 16, 4, 4, 6, 6))
    _, spA = _space(gA, ch_max=2, **big)
    _, spB = _space(gB, ch_max=4, **big)
    dA = _repaired_design(spA, seed=3)
    dB = migrate(dA, spA, spB)
    assert_design_feasible(dB, spB)
    assert_same_design(migrate(dB, spB, spA), dA)
    rA, rB = _superset(ref_wl, ref_presets)
    assert_same_design(dB, ref_enc.migrate(
        dA, _ref_space(rA, ch_max=2, **big), _ref_space(rB, ch_max=4, **big)))


def test_migrate_across_structurally_different_graphs():
    lib, ref_lib = P.workload_library(), ref_presets.workload_library()
    _, src_space = _space(lib["attn_qwen2_72b"], ch_max=2)
    ref_src = _ref_space(ref_lib["attn_qwen2_72b"], ch_max=2)
    d = _repaired_design(src_space, seed=4)
    for name in ("attn_qwen2_5_32b", "conv_whisper", "scan_falcon_mamba"):
        _, dst_space = _space(lib[name], ch_max=3)
        out = migrate(d, src_space, dst_space)
        assert_design_feasible(out, dst_space)
        assert_same_design(out, ref_enc.migrate(
            d, ref_src, _ref_space(ref_lib[name], ch_max=3)))


def test_portable_design_record_structure():
    _, space = _space(P.transformer_block())
    d = _repaired_design(space, seed=5)
    pd = to_portable(d, space)
    assert isinstance(pd, PortableDesign) and len(pd.records) == space.W
    sigs = [workload_signature(w) for w in space.spec.graph.workloads]
    assert [r["signature"] for r in pd.records] == sigs
    # the two identical heads share a signature yet keep their own records
    assert sigs[0] == sigs[1]
    assert_same_design(from_portable(pd, space), d)
    with pytest.raises(ValueError):
        from_portable(PortableDesign([], 0, 0, 0), space)


# ---------------------------------------------------------------------------
# cross-spec manifest + crash-safe persistence
# ---------------------------------------------------------------------------
def _entry(dim=4, seed=0, n_evals=8):
    rng = np.random.default_rng(seed)
    return dict(embedding=rng.random(dim), dims=(1, 2, 1),
                n_evals=n_evals, budget_covered=n_evals,
                searched=("latency_ns",), digest={"W": 1})


def _both(fill, **policy):
    """The same mutations applied to the port's manifest and the
    reference's."""
    out = []
    for mod in (ref_arc, None):
        m = (mod.ArchiveManifest(policy=mod.ManifestPolicy(**policy))
             if mod is not None
             else ArchiveManifest(policy=ManifestPolicy(**policy)))
        fill(m)
        out.append(m)
    return out


def assert_same_nearest(a, b):
    assert [k for k, _ in a] == [k for k, _ in b]
    np.testing.assert_allclose([d for _, d in a], [d for _, d in b],
                               rtol=1e-12, atol=1e-12)


def test_manifest_roundtrip_and_nearest(tmp_path):
    m = ArchiveManifest(tmp_path / MANIFEST_NAME)
    ref = ref_arc.ArchiveManifest(tmp_path / "ref.npz")
    for mm in (m, ref):
        for i in range(4):
            e = _entry(seed=i)
            mm.update(f"k{i}", e["embedding"], e["dims"], e["n_evals"],
                      e["budget_covered"], e["searched"], digest={"seed": i})
        mm.update("empty", np.zeros(4), (1, 1, 1), 0, 0, ())
    m.save()
    back = ArchiveManifest.load(tmp_path / MANIFEST_NAME)
    assert len(back) == 5
    np.testing.assert_allclose(back.entries["k2"]["embedding"],
                               m.entries["k2"]["embedding"])
    assert back.entries["k3"]["digest"] == {"seed": 3}
    assert back.entries["k1"]["searched"] == ("latency_ns",)

    q = m.entries["k0"]["embedding"]
    got = back.nearest(q, k=10)
    assert got[0] == ("k0", 0.0)
    assert [k for k, _ in got] == sorted(
        (k for k in back.entries if k != "empty"),
        key=lambda k: np.linalg.norm(back.entries[k]["embedding"] - q))
    assert_same_nearest(got, ref.nearest(q, k=10))
    got_ex = back.nearest(q, k=10, exclude=("k0",))
    assert all(k != "k0" for k, _ in got_ex) and len(got_ex) == 3
    back.update("odd", np.zeros(7), (1, 1, 1), 5, 5, ())
    assert all(k != "odd" for k, _ in back.nearest(q, k=10))


def test_manifest_corrupt_or_truncated_file_is_ignored(tmp_path):
    p = tmp_path / MANIFEST_NAME
    m = ArchiveManifest(p)
    m.update("k", np.ones(3), (1, 1, 1), 4, 4, ())
    m.save()
    p.write_bytes(p.read_bytes()[:20])
    with pytest.warns(UserWarning, match="unreadable explore manifest"):
        back = ArchiveManifest.load(p)
    assert len(back) == 0
    p.write_bytes(b"this is not an npz at all")
    with pytest.warns(UserWarning):
        assert len(ArchiveManifest.load(p)) == 0
    assert len(ArchiveManifest.load(tmp_path / "nope.npz")) == 0


def test_atomic_savez_no_tmp_residue_and_archive_load(tmp_path):
    p = atomic_savez(tmp_path / "a.npz", x=np.arange(4))
    with np.load(p) as z:
        np.testing.assert_array_equal(z["x"], np.arange(4))
    assert [f.name for f in tmp_path.iterdir()] == ["a.npz"]
    arc = ParetoArchive(8, {"tag": np.zeros((), np.int32)}, n_obj=2,
                        device="cpu")
    arc.insert({"tag": np.zeros(1, np.int32)}, np.array([[1.0, 2.0]]))
    arc.save(tmp_path / "arc.npz")
    assert sorted(f.name for f in tmp_path.iterdir()) == ["a.npz", "arc.npz"]
    assert len(ParetoArchive.load(tmp_path / "arc.npz", device="cpu")) == 1
    # an archive npz the reference wrote loads on the port, row for row
    ref = ref_arc.ParetoArchive(4, {"tag": np.zeros((2,), np.int32)},
                                n_obj=2)
    ref.objs[:2] = [[1.0, 2.0], [2.0, 1.0]]
    ref.valid[:2] = True
    ref.designs["tag"][:2] = [[1, 2], [3, 4]]
    ref.n_evals, ref.searched = 16, ("latency_ns",)
    ref.save(tmp_path / "ref.npz")
    got = ParetoArchive.load(tmp_path / "ref.npz", device="cpu")
    assert len(got) == 2 and got.n_evals == 16
    assert got.searched == ("latency_ns",)
    designs, objs = got.front()
    np.testing.assert_array_equal(objs, [[1.0, 2.0], [2.0, 1.0]])
    np.testing.assert_array_equal(designs["tag"], [[1, 2], [3, 4]])


def test_truncated_archive_npz_is_not_fatal_to_the_service(tmp_path):
    g = _tiny_graph()
    r = _svc(tmp_path).explore(g, OBJ, budget=16, ch_max=2,
                               space_kwargs=TINY_SPACE_KW)
    path = tmp_path / f"{r.cache_key}.npz"
    path.write_bytes(path.read_bytes()[:30])      # simulated torn write
    with pytest.warns(UserWarning, match="unreadable explore cache"):
        r2 = _svc(tmp_path).explore(g, OBJ, budget=16, ch_max=2,
                                    space_kwargs=TINY_SPACE_KW)
    assert not r2.from_cache and len(r2.front_objs) >= 1


# ---------------------------------------------------------------------------
# manifest growth policy: LRU eviction, dedup, trust table
# ---------------------------------------------------------------------------
def test_manifest_lru_eviction_order(tmp_path):
    def fill(m):
        for i in range(3):
            e = _entry(seed=i)
            m.update(f"k{i}", e["embedding"], e["dims"], e["n_evals"],
                     e["budget_covered"], e["searched"], digest={})
        m.touch("k0")
        e = _entry(seed=9)
        m.update("k3", e["embedding"], e["dims"], e["n_evals"],
                 e["budget_covered"], e["searched"], digest={})
    ref, m = _both(fill, max_entries=3)
    assert set(m.entries) == {"k0", "k2", "k3"} == set(ref.entries)
    e = _entry(seed=10)
    m.update("k4", e["embedding"], e["dims"], e["n_evals"],
             e["budget_covered"], e["searched"], digest={})
    assert set(m.entries) == {"k0", "k3", "k4"}


def test_manifest_dedup_merges_near_identical_entries():
    base = np.ones(4)

    def fill(m):
        m.update("a", base, (1, 2, 1), 32, 32, ("latency_ns",), digest={})
        m.update("b", base + 0.1, (1, 2, 1), 8, 8, ("cost_usd",), digest={})
    ref, m = _both(fill, max_entries=8, dedup_radius=0.5)
    assert set(m.entries) == {"b"} == set(ref.entries)
    ent = m.entries["b"]
    assert ent["n_evals"] == 32 and ent["budget_covered"] == 32
    assert set(ent["searched"]) == {"cost_usd", "latency_ns"}
    assert ent["searched"] == ref.entries["b"]["searched"]
    np.testing.assert_array_equal(ent["embedding"], base + 0.1)
    m.update("c", base + 10.0, (1, 2, 1), 4, 4, (), digest={})
    assert set(m.entries) == {"b", "c"}
    m.entries["e"] = dict(embedding=base.copy(), dims=(1, 2, 1),
                          n_evals=4, budget_covered=4, searched=(),
                          digest={}, last_used=99)
    m.dedup()
    assert "e" not in m.entries and "b" in m.entries
    assert m.entries["b"]["last_used"] == 99


def test_manifest_v2_roundtrip_preserves_lru_and_trust(tmp_path):
    p = tmp_path / MANIFEST_NAME
    m = ArchiveManifest(p, policy=ManifestPolicy(max_entries=8))
    for i in range(3):
        e = _entry(seed=i)
        m.update(f"k{i}", e["embedding"], e["dims"], e["n_evals"],
                 e["budget_covered"], e["searched"], digest={"i": i})
    m.touch("k0")
    m.record_transfer("k1", "k0", np.arange(4, dtype=float), 0.75)
    m.save()
    for back in (ArchiveManifest.load(p), ref_arc.ArchiveManifest.load(p)):
        # the port's file is the reference's format: both read it alike
        assert back.clock == m.clock
        for k in m.entries:
            assert back.entries[k]["last_used"] == m.entries[k]["last_used"]
            assert back.entries[k]["digest"] == m.entries[k]["digest"]
        assert len(back.trust) == 1
        r = back.trust[0]
        assert (r["src"], r["dst"], r["lift"]) == ("k1", "k0", 0.75)
        np.testing.assert_allclose(r["delta"], np.arange(4, dtype=float))
    back = ArchiveManifest.load(p)
    back.policy = ManifestPolicy(max_entries=2)
    back.enforce()
    assert "k0" in back.entries              # touched last => survives


def test_manifest_save_tolerates_mixed_embedding_dims(tmp_path):
    p = tmp_path / MANIFEST_NAME
    m = ArchiveManifest(p)
    m.update("old", np.ones(4), (1, 2, 1), 8, 8, (), digest={})
    m.update("new", np.ones(9), (1, 2, 1), 8, 8, (), digest={})
    m.save()
    back = ArchiveManifest.load(p)
    assert back.entries["old"]["embedding"].shape == (4,)
    assert back.entries["new"]["embedding"].shape == (9,)
    assert [k for k, _ in back.nearest(np.ones(9), k=5)] == ["new"]


def test_manifest_trust_records_are_bounded():
    m = ArchiveManifest(policy=ManifestPolicy(max_trust_records=5))
    for i in range(12):
        m.record_transfer(f"s{i}", "d", np.zeros(3), 0.5)
    assert len(m.trust) == 5
    assert m.trust[0]["src"] == "s7"         # oldest rolled off


def test_trust_model_fit_predict_and_reweighting():
    def fill(m):
        rng = np.random.default_rng(0)
        for i in range(8):
            m.record_transfer(f"near{i}", "d", rng.random(4) * 0.1, 0.9)
            m.record_transfer(f"far{i}", "d", 2.0 + rng.random(4), 0.1)
        m.update("e1", np.zeros(4), (1, 2, 1), 8, 8, (), digest={})
        m.update("e2", np.full(4, 3.0), (1, 2, 1), 8, 8, (), digest={})
    ref, m = _both(fill)
    tm = m.trust_model(dim=4)
    assert isinstance(tm, TrustModel)
    # 16 records: the reference fits the same ridge model
    np.testing.assert_allclose(tm.weights, ref.trust_model(dim=4).weights,
                               rtol=1e-12, atol=1e-12)
    assert tm.predict(np.zeros(4)) > tm.predict(np.full(4, 2.5))
    assert tm.predict(np.zeros(7)) == 0.0
    assert fit_trust_model(m.trust[:2]) is None
    q = np.full(4, 0.05)
    raw = dict(m.nearest(q, k=2))
    wtd = dict(m.nearest(q, k=2, trust=tm))
    assert set(raw) == set(wtd) == {"e1", "e2"}
    for k in raw:
        assert wtd[k] <= raw[k] + 1e-12
    assert_same_nearest(m.nearest(q, k=2, trust=tm),
                        ref.nearest(q, k=2, trust=ref.trust_model(dim=4)))


def test_trust_model_predict_clamps_negative_lift():
    tm = TrustModel(weights=np.array([0.5, -10.0, -10.0, -10.0, -10.0]))
    assert tm.predict(np.full(4, 5.0)) == 0.0
    assert tm.predict(np.zeros(4)) == 0.5
    m = ArchiveManifest(policy=ManifestPolicy())
    m.update("a", np.zeros(4), (1, 2, 1), 8, 8, (), digest={})
    m.update("b", np.full(4, 8.0), (1, 2, 1), 8, 8, (), digest={})
    out = dict(m.nearest(np.full(4, 7.0), k=2, trust=tm))
    assert all(np.isfinite(v) and v >= 0.0 for v in out.values())
    assert out["b"] < out["a"]


def test_fit_trust_model_uses_modal_dim():
    rng = np.random.default_rng(1)
    records = [{"src": f"s{i}", "dst": "d",
                "delta": rng.random(4), "lift": 0.5}
               for i in range(6)]
    records.append({"src": "drift", "dst": "d",
                    "delta": rng.random(9), "lift": 0.5})
    tm = fit_trust_model(records)
    assert isinstance(tm, TrustModel)
    assert tm.weights.shape == (5,)
    np.testing.assert_allclose(tm.weights,
                               ref_arc.fit_trust_model(records).weights,
                               rtol=1e-12, atol=1e-12)
    tied = records[:2] + [{"src": "n1", "dst": "d",
                           "delta": rng.random(9), "lift": 0.4},
                          {"src": "n2", "dst": "d",
                           "delta": rng.random(9), "lift": 0.6}]
    tm2 = fit_trust_model(tied, min_records=2)
    assert tm2 is not None and tm2.weights.shape == (10,)
    np.testing.assert_allclose(
        tm2.weights, ref_arc.fit_trust_model(tied, min_records=2).weights,
        rtol=1e-12, atol=1e-12)


def test_embedding_delta_symmetric_and_zero_on_match():
    lib = P.workload_library()
    a = workload_features(lib["attn_qwen2_72b"])
    b = workload_features(lib["conv_whisper"])
    np.testing.assert_allclose(embedding_delta(a, b), embedding_delta(b, a))
    assert np.all(embedding_delta(a, a) == 0.0)
    assert np.all(embedding_delta(a, b) >= 0.0)
    assert embedding_delta(a, b).shape == (WL_EMBED_DIM,)


def test_portable_signature_identity_and_sensitivity():
    _, space = _space(P.transformer_block())
    ref_space = _ref_space(ref_presets.transformer_block())
    d = _repaired_design(space, seed=7)
    sig = portable_signature(d, space)
    assert sig == ref_enc.portable_signature(d, ref_space)
    assert portable_signature(migrate(d, space, space), space) == sig
    d2 = {k: np.array(v) for k, v in d.items()}
    d2["shape"][0, 0] = 2 if int(d2["shape"][0, 0]) == 1 \
        else int(d2["shape"][0, 0]) - 1
    assert portable_signature(d2, space) != sig
    assert portable_signature(d2, space) == ref_enc.portable_signature(
        d2, ref_space)
    d3 = {k: np.array(v) for k, v in d.items()}
    d3["packaging"] = np.asarray((int(d3["packaging"]) + 1) % 3)
    assert portable_signature(d3, space) != sig


# ---------------------------------------------------------------------------
# the service's transfer warm-start path
# ---------------------------------------------------------------------------
def test_transfer_seeds_cold_query_from_neighbor_archive(tmp_path):
    svc = _svc(tmp_path)
    r1 = svc.explore(_tiny_graph(64), OBJ, budget=16, ch_max=2,
                     space_kwargs=TINY_SPACE_KW)
    assert not r1.from_cache
    assert r1.cache_key in svc.manifest.entries          # indexed on save
    ent = svc.manifest.entries[r1.cache_key]
    assert ent["n_evals"] == r1.n_evals_run
    assert ent["digest"] is not None

    r2 = svc.explore(_tiny_graph(96), OBJ, budget=16, ch_max=2,
                     space_kwargs=TINY_SPACE_KW, transfer=True)
    assert not r2.from_cache
    assert r2.transferred_from == (r1.cache_key,)
    assert r2.n_transfer_seeds >= 1
    assert len(r2.front_objs) >= 1

    r3 = _svc(tmp_path).explore(_tiny_graph(128), OBJ, budget=16, ch_max=2,
                                space_kwargs=TINY_SPACE_KW, transfer=True)
    assert len(r3.transferred_from) >= 1

    r4 = svc.explore(_tiny_graph(160), OBJ, budget=16, ch_max=2,
                     space_kwargs=TINY_SPACE_KW)
    assert r4.transferred_from == () and r4.n_transfer_seeds == 0


def test_transfer_falls_back_to_balanced_init(tmp_path):
    r = _svc(tmp_path).explore(_tiny_graph(), OBJ, budget=16, ch_max=2,
                               space_kwargs=TINY_SPACE_KW, transfer=True)
    assert not r.from_cache
    assert r.transferred_from == ()
    assert r.n_transfer_seeds == 1            # the balanced_init seed
    assert len(r.front_objs) >= 1


def test_transfer_warm_hit_short_circuits(tmp_path):
    svc = _svc(tmp_path)
    g = _tiny_graph()
    svc.explore(g, OBJ, budget=16, ch_max=2, space_kwargs=TINY_SPACE_KW)
    r = svc.explore(g, OBJ, budget=16, ch_max=2,
                    space_kwargs=TINY_SPACE_KW, transfer=True)
    assert r.from_cache and r.n_evals_run == 0
    assert r.transferred_from == () and r.n_transfer_seeds == 0


# ---------------------------------------------------------------------------
# transfer v2: warm-archive seeding, seed dedup, stale-manifest reload
# ---------------------------------------------------------------------------
def test_warm_archive_refinement_takes_transfer_seeds(tmp_path):
    svc = _svc(tmp_path)
    neighbor = svc.explore(_tiny_graph(64), OBJ, budget=32, ch_max=2,
                           space_kwargs=TINY_SPACE_KW)
    half = svc.explore(_tiny_graph(96), OBJ, budget=16, ch_max=2,
                       space_kwargs=TINY_SPACE_KW)
    assert not half.from_cache
    r = svc.explore(_tiny_graph(96), OBJ, budget=48, ch_max=2,
                    space_kwargs=TINY_SPACE_KW, transfer=True)
    assert not r.from_cache
    assert r.transferred_from == (neighbor.cache_key,)
    assert 1 <= r.n_transfer_seeds <= svc.nsga.pop // 2
    assert any(t["src"] == neighbor.cache_key
               and t["dst"] == r.cache_key
               and 0.0 <= t["lift"] <= 1.0 for t in svc.manifest.trust)
    assert half.cache_key == r.cache_key


def test_warm_refinement_with_own_front_injects_nothing(tmp_path):
    import shutil
    g = _tiny_graph(64)
    twin, plain = tmp_path / "twin", tmp_path / "plain"
    svc0 = _svc(twin)
    r0 = svc0.explore(g, OBJ, budget=16, ch_max=2,
                      space_kwargs=TINY_SPACE_KW, key=3)
    ck = r0.cache_key
    ent = svc0.manifest.entries[ck]
    shutil.copy(twin / f"{ck}.npz", twin / "feedbeefdeadbeef0000.npz")
    svc0.manifest.update("feedbeefdeadbeef0000", ent["embedding"],
                         (2, 2, 1), ent["n_evals"], ent["budget_covered"],
                         ent["searched"], digest=ent["digest"])
    svc0.manifest.save()
    shutil.copytree(twin, plain)
    rt = _svc(twin).explore(g, OBJ, budget=48, ch_max=2,
                            space_kwargs=TINY_SPACE_KW, transfer=True, key=5)
    rp = _svc(plain).explore(g, OBJ, budget=48, ch_max=2,
                             space_kwargs=TINY_SPACE_KW, transfer=False,
                             key=5)
    assert rt.n_transfer_seeds == 0 and rt.transferred_from == ()
    np.testing.assert_array_equal(rt.front_objs, rp.front_objs)
    np.testing.assert_array_equal(rt.trace.archive_hv, rp.trace.archive_hv)


def test_second_service_sees_fresh_manifest_before_acting(tmp_path):
    pol = ManifestPolicy(max_entries=8)
    a = _svc(tmp_path, manifest_policy=pol)
    b = _svc(tmp_path, manifest_policy=pol)
    assert len(b.manifest) == 0
    ra = a.explore(_tiny_graph(64), OBJ, budget=16, ch_max=2,
                   space_kwargs=TINY_SPACE_KW)
    assert ra.cache_key in b.manifest.entries
    rb = b.explore(_tiny_graph(96), OBJ, budget=16, ch_max=2,
                   space_kwargs=TINY_SPACE_KW, transfer=True)
    assert rb.transferred_from == (ra.cache_key,)
    assert b.manifest is b.manifest


# ---------------------------------------------------------------------------
# transferred seed populations in the scalarized engines
# ---------------------------------------------------------------------------
def test_optimize_accepts_transferred_seed_population(tmp_path):
    _, src_space = _space(_tiny_graph(64))
    dst_spec, dst_space = _space(_tiny_graph(96))
    seeds = [migrate(_repaired_design(src_space, seed=s), src_space,
                     dst_space) for s in range(2)]
    r = Session(cache_dir=tmp_path, device="cpu").submit(Query(
        Problem.from_spec(dst_spec, dst_space), engine="bo_sa",
        weights=(1.0, 1.0, 0.0, 0.0), seed_designs=seeds,
        engine_opts=dict(bo_fields=(), n_init=2,
                         sa=SAConfig(steps=10, chains=2))), key=0)
    assert np.isfinite(r.best_objective)
    assert len(r.raw.history) == 2
    assert r.provenance.n_transfer_seeds == 2
