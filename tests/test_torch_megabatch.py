"""Cross-problem megabatching in the port (``make_nsga_fused`` and the
service's fused lanes), mirroring the megabatch cases of
``tests/test_scale.py``, and the lane axis beneath it: batched dominance
counts against the reference's per-lane counts, crowding and hypervolume
per lane against the single-pool results, per-row spec tensors in the
evaluator, and per-lane random draws.  Small sizes, on the CPU."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.explore import quantize as ref_quantize
from repro.kernels.pareto_rank.ref import \
    dominance_counts_ref as ref_dominance_counts

from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as tp
from repro_torch.core.encoding import DesignSpace, mutate, random_design
from repro_torch.core.evaluate import (SystemSpec, evaluate_arrays,
                                       spec_tensors)
from repro_torch.explore import quantize
from repro_torch.explore import service as service_mod
from repro_torch.explore.archive import (crowding_distance, dominance_counts,
                                         hypervolume_2d_jit)
from repro_torch.explore.nsga import NSGAConfig, make_nsga, make_nsga_fused
from repro_torch.explore.service import BudgetPolicy
from repro_torch.runtime import LaneGenerators, generator

TINY_SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
OBJ = ("latency_ns", "cost_usd")
NAMES = ("att1", "att2", "att3")


def _tiny(name, ch_max=2):
    spec = SystemSpec.build(tp.bert_mms()[name], ch_max=ch_max)
    return spec, DesignSpace(spec, **TINY_SPACE_KW)


def _lane_pools(L, n, k, seed, special=False):
    """L pools on a small value grid (many exact ties); ``special`` adds
    NaN and +-inf objectives."""
    rng = np.random.default_rng(seed)
    objs = rng.integers(0, 5, size=(L, n, k)).astype(np.float32)
    objs[:, n // 2:n // 2 + 4] = objs[:, :4]
    if special:
        u = rng.random((L, n, k))
        objs[u < 0.05] = np.nan
        objs[(u >= 0.05) & (u < 0.1)] = np.inf
        objs[(u >= 0.1) & (u < 0.15)] = -np.inf
    valid = rng.random((L, n)) < 0.85
    return objs, valid


# ---------------------------------------------------------------------------
# the pow2 lane lattice (the reference's quantize, copied)
# ---------------------------------------------------------------------------
def test_bucket_lanes():
    assert [quantize.bucket_lanes(n) for n in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]
    assert quantize.bucket_lanes(9, max_lanes=8) == 8
    for n in range(1, 20):
        for cap in (None, 2, 8, 6):
            assert quantize.bucket_lanes(n, cap) == \
                ref_quantize.bucket_lanes(n, cap)


# ---------------------------------------------------------------------------
# the lane axis of the dominance math
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,n,k,special", [
    (8, 128, 2, False), (8, 64, 2, False), (3, 768, 4, False),
    (4, 97, 3, True), (1, 128, 2, False)])
def test_batched_dominance_counts_equal_reference_per_lane(L, n, k,
                                                           special):
    objs, valid = _lane_pools(L, n, k, seed=L * n + k, special=special)
    got = dominance_counts(torch.as_tensor(objs), torch.as_tensor(valid))
    assert got.shape == (L, n) and got.dtype == torch.int32
    for i in range(L):
        want = np.asarray(ref_dominance_counts(jnp.asarray(objs[i]),
                                               jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("L,n,k", [(4, 64, 2), (3, 97, 3), (2, 32, 1)])
def test_crowding_and_hypervolume_per_lane_equal_single_pools(L, n, k):
    objs, valid = _lane_pools(L, n, k, seed=7 * n + k)
    o, v = torch.as_tensor(objs), torch.as_tensor(valid)
    cd = crowding_distance(o, v)
    hv = hypervolume_2d_jit(o[..., :2] if k > 1 else o.expand(-1, -1, 2),
                            (5.0, 5.0), valid=v)
    for i in range(L):
        assert torch.equal(cd[i], crowding_distance(o[i], v[i]))
        pts = o[i, :, :2] if k > 1 else o[i].expand(-1, 2)
        assert torch.equal(hv[i], hypervolume_2d_jit(pts, (5.0, 5.0),
                                                     valid=v[i]))


# ---------------------------------------------------------------------------
# per-row problems: evaluator and variation
# ---------------------------------------------------------------------------
def test_per_row_spec_tensors_evaluate_each_row_against_its_problem():
    probs = [_tiny(n) for n in NAMES]
    pops = [random_design(i, p[1], n=8, device="cpu")
            for i, p in enumerate(probs)]
    arrs = [spec_tensors(p[0].arrays, "cpu") for p in probs]
    rows = {k: torch.stack([a[k] for a in arrs]).repeat_interleave(8, 0)
            for k in arrs[0]}
    design = {k: torch.cat([p[k] for p in pops]) for k in pops[0]}
    spec0 = probs[0][0]
    dims = (spec0.W, spec0.CH, spec0.E)
    fused = evaluate_arrays(rows, design, dims, lanes=3)
    for i in range(3):
        single = evaluate_arrays(arrs[i], pops[i], dims)
        for key in ("latency_ns", "energy_pj", "cost_usd", "area_mm2",
                    "edp"):
            assert torch.equal(fused[key][8 * i:8 * (i + 1)], single[key])


def test_lane_generators_draw_each_lanes_own_stream():
    probs = [_tiny(n) for n in NAMES]
    spec0, space0 = probs[0]
    arrs = [spec_tensors(p[0].arrays, "cpu") for p in probs]
    nl = [a["loopmask"].sum(1).to(torch.int32) for a in arrs]
    lanes = LaneGenerators([generator(s, "cpu") for s in (3, 4, 5)])
    imm = random_design(lanes, space0, 3 * 4,
                        nl=torch.stack(nl).repeat_interleave(4, 0),
                        bounds=torch.stack([a["bounds"] for a in arrs])
                        .repeat_interleave(4, 0), device="cpu")
    moved = mutate(lanes, imm, space0,
                   nl=torch.stack(nl).repeat_interleave(4, 0),
                   bounds=torch.stack([a["bounds"] for a in arrs])
                   .repeat_interleave(4, 0))
    for i, s in enumerate((3, 4, 5)):
        g = generator(s, "cpu")
        one = random_design(g, space0, 4, nl=nl[i], bounds=arrs[i]["bounds"],
                            device="cpu")
        one_m = mutate(g, one, space0, nl=nl[i], bounds=arrs[i]["bounds"])
        for k in one:
            assert torch.equal(imm[k][4 * i:4 * (i + 1)], one[k])
            assert torch.equal(moved[k][4 * i:4 * (i + 1)], one_m[k])


# ---------------------------------------------------------------------------
# the fused runner: lane i == unbatched run i
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pmx", [False, True])
def test_fused_lanes_match_unbatched_runs(pmx):
    """Each lane of ``make_nsga_fused`` evolves the same designs as its
    unbatched ``make_nsga`` twin (designs exact; raw metrics rtol 1e-6),
    and the run's selection ranks every lane in one batched call."""
    cfg = NSGAConfig(pop=8, generations=2, pmx_placement=pmx)
    probs = [_tiny(n) for n in NAMES]
    spec0, space0 = probs[0]
    seeds = [11, 12, 13]
    pops = [random_design(100 + i, p[1], n=cfg.pop, device="cpu")
            for i, p in enumerate(probs)]
    fused = make_nsga_fused(spec0, space0, OBJ, cfg, lanes=3, device="cpu")(
        seeds, {k: torch.stack([p[k] for p in pops]) for k in pops[0]},
        [p[0].arrays for p in probs])
    assert fused[1].shape == (3, cfg.pop, 4)
    assert fused[4].shape == (3, cfg.generations, cfg.pop, 4)
    assert fused[6]["hypervolume"].shape == (3, cfg.generations, 1)
    for j, ((spec, _), seed, pop0) in enumerate(zip(probs, seeds, pops)):
        single = make_nsga(spec0, space0, OBJ, cfg, device="cpu")(
            seed, pop0, arrays=spec.arrays)
        for k in single[0]:
            assert torch.equal(single[0][k], fused[0][k][j])
        for k in single[3]:
            assert torch.equal(single[3][k], fused[3][k][j])
        np.testing.assert_allclose(fused[1][j].numpy(), single[1].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(fused[4][j].numpy(), single[4].numpy(),
                                   rtol=1e-6)
        for k in single[6]:
            np.testing.assert_allclose(fused[6][k][j].numpy(),
                                       single[6][k].numpy(), rtol=1e-6)


def test_fused_runner_checks_its_lane_count():
    spec0, space0 = _tiny("att1")
    with pytest.raises(ValueError, match="lanes"):
        make_nsga_fused(spec0, space0, OBJ, NSGAConfig(pop=8), lanes=0,
                        device="cpu")
    run = make_nsga_fused(spec0, space0, OBJ,
                          NSGAConfig(pop=8, generations=1), lanes=2,
                          device="cpu")
    pop = random_design(0, space0, n=8, device="cpu")
    with pytest.raises(ValueError, match="expected 2"):
        run([1], {k: v[None] for k, v in pop.items()}, [None])


# ---------------------------------------------------------------------------
# megabatching through the service: fronts identical
# ---------------------------------------------------------------------------
def _queries(names=NAMES, budget=32, **kw):
    return [Query(Problem(tp.bert_mms()[n], objectives=OBJ, ch_max=2,
                          space_kwargs=TINY_SPACE_KW),
                  budget=budget, engine="nsga", **kw)
            for n in names]


def _fused_calls(monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("lanes"))
        return make_nsga_fused(*a, **kw)
    monkeypatch.setattr(service_mod, "make_nsga_fused", spy)
    return calls


def test_megabatch_fronts_match_sequential(tmp_path, monkeypatch):
    """Three distinct problems of one padded shape: the fused megabatch
    answers with the same fronts as three sequential refinements —
    designs bit-identical, metrics rtol 1e-6, spend equal."""
    calls = _fused_calls(monkeypatch)

    def _run(sub, megabatch):
        s = Session(cache_dir=tmp_path / sub,
                    nsga=NSGAConfig(pop=8, generations=2),
                    policy=BudgetPolicy(adaptive=False,
                                        chunk_generations=1,
                                        megabatch=megabatch),
                    device="cpu")
        return s.submit(_queries(), key=5)

    fused = _run("fused", True)
    assert calls == [4]                 # 3 lanes, pow2-padded to 4
    seq = _run("seq", False)
    assert calls == [4]
    for rf, rs in zip(fused, seq):
        np.testing.assert_allclose(rf.front_metrics, rs.front_metrics,
                                   rtol=1e-6)
        assert len(rf.front_designs) == len(rs.front_designs)
        for df, ds in zip(rf.front_designs, rs.front_designs):
            assert sorted(df) == sorted(ds)
            for k in df:
                np.testing.assert_array_equal(df[k], ds[k])
        assert rf.provenance.n_evals_run == rs.provenance.n_evals_run
        np.testing.assert_array_equal(rf.trace.archive_hv,
                                      rs.trace.archive_hv)


def test_megabatch_query_optout_stays_sequential(tmp_path, monkeypatch):
    """A ``Query(megabatch=False)`` group never fuses — and the batch still
    answers every query correctly."""
    calls = _fused_calls(monkeypatch)
    s = Session(cache_dir=tmp_path, nsga=NSGAConfig(pop=8, generations=2),
                policy=BudgetPolicy(adaptive=False, chunk_generations=1),
                device="cpu")
    a, b = _queries(("att1", "att2"), budget=16)
    a.megabatch = False
    out = s.submit([a, b], key=3)
    assert calls == []                  # one willing group: nothing fuses
    for r in out:
        assert r.provenance.n_evals_run == 16
        assert len(r.front_objs) >= 1


def test_budget_policy_fuses_by_default(tmp_path, monkeypatch):
    """``BudgetPolicy()`` megabatches, as the reference's does; a batch of
    distinct cold problems goes through one fused run at the default
    lane cap, and the warm repeat is served from cache."""
    assert BudgetPolicy().megabatch and BudgetPolicy().megabatch_lanes == 8
    calls = _fused_calls(monkeypatch)
    s = Session(cache_dir=tmp_path, nsga=NSGAConfig(pop=8), device="cpu")
    out = s.submit(_queries(("att1", "att2"), budget=16), key=1)
    assert calls == [2]
    assert [r.provenance.n_evals_run for r in out] == [16, 16]
    again = Session(cache_dir=tmp_path, nsga=NSGAConfig(pop=8),
                    device="cpu").submit(_queries(("att1", "att2"),
                                                  budget=16), key=1)
    assert all(r.provenance.from_cache for r in again)
    assert calls == [2]


def test_megabatch_lanes_cap_splits_buckets(tmp_path, monkeypatch):
    """Four problems under a 2-lane cap run as two fused pairs."""
    calls = _fused_calls(monkeypatch)
    s = Session(cache_dir=tmp_path, nsga=NSGAConfig(pop=8, generations=2),
                policy=BudgetPolicy(adaptive=False, megabatch_lanes=2),
                device="cpu")
    out = s.submit(_queries(("att1", "att2", "att3", "att4"), budget=16),
                   key=2)
    assert calls == [2, 2]
    assert all(r.provenance.n_evals_run == 16 for r in out)


def test_resume_never_fuses(tmp_path, monkeypatch):
    calls = _fused_calls(monkeypatch)
    s = Session(cache_dir=tmp_path, nsga=NSGAConfig(pop=8), device="cpu")
    out = s.submit(_queries(("att1", "att2"), budget=16), key=4,
                   resume=True)
    assert calls == [] and all(r.provenance.n_evals_run == 16 for r in out)
