"""The port's calibration (``repro_torch.calib``) on the CPU, held against
the reference (``repro.calib``).

* the 18 cases of ``tests/test_calib.py`` on the port: autograd reaches
  every fittable field (finite jacobian, every ``METRIC_FIELDS`` entry
  non-zero on the golden design, ``core_buf_bw`` under starvation), the
  ``tech_key`` identity, the tech-aware cache key, identity corrections
  as bitwise no-ops, measurements and reports, the fit, the
  ``CalibratedTech`` artifact lifecycle and tech carried by name;
* parity: ``simulator_sweep`` values and ``measurements_digest`` equal the
  reference's exactly; the port's reverse-mode jacobian is within rtol
  1e-4 of ``jax.jacfwd`` of the reference on the golden and the starved
  tech; the reference's ``bench_validation`` split fit at 100 steps lands
  within rtol 1e-3 of the reference's fitted values and within 1e-4
  (absolute) of its held-out error; system-row predictions, with the
  reference's baseline design carried across, within rtol 1e-4; artifacts
  load across the packages with equal digests and a tamper is detected.

As a script it prints a baseline-row fit (the published Simba /
NN-Baton rows under ``DEFAULT_FREE``) on both packages, with the port's
own baseline designs and with the reference's carried across:
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_calib.py``.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.calib as RC
import repro.core as C
from repro.calib.fit import _build_predictor as ref_build_predictor
from repro.core.constants import FITTABLE_FIELDS as REF_FITTABLE
from repro.core.constants import METRIC_FIELDS as REF_METRIC_FIELDS
from repro.core.evaluate import evaluate_system as ref_evaluate_system

from repro_torch import convert
from repro_torch.api import Problem, Query, Session
from repro_torch.calib import (CalibratedTech, Measurement,
                               baseline_measurements, error_report, fit,
                               load_calibrated, load_report,
                               measurements_digest, predict, simulator_sweep)
from repro_torch.calib.fit import DEFAULT_FREE
from repro_torch.core import baselines as port_baselines
from repro_torch.core import constants as tc
from repro_torch.core import presets as tp
from repro_torch.core.constants import (DEFAULT_TECH, FITTABLE_FIELDS,
                                        METRIC_FIELDS, TechConstants,
                                        tech_from_dict, tech_key,
                                        tech_to_dict)
from repro_torch.core.evaluate import evaluate_system
from repro_torch.core.optimizer import METRIC_KEYS
from test_golden_metrics import _fixed_design

# the reference's bench_validation calibration split
SHAPES = RC.measurements.SWEEP_SHAPES
BWS = (128.0, 16.0)


# ---------------------------------------------------------------------------
# golden design and jacobians
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    """(reference spec, reference design, port spec, port design (P=1))."""
    spec = C.SystemSpec.build(C.presets.transformer_block(), ch_max=2)
    design = _fixed_design(spec)
    pdesign = convert.design_to_torch(
        {k: np.asarray(v)[None] for k, v in design.items()}, device="cpu")
    return spec, design, convert.spec_from_reference(spec), pdesign


def _with(base, vals):
    return dataclasses.replace(
        base, **{f: v for f, v in zip(FITTABLE_FIELDS, vals)})


def _jacobian(spec, design, base):
    """(len(METRIC_KEYS), len(FITTABLE_FIELDS)) jacobian of the port's
    evaluator at ``base``, by reverse-mode autograd."""
    def metrics_of(vals):
        out = evaluate_system(spec, design, tech=_with(base, vals))
        return torch.stack([out[k][0] for k in METRIC_KEYS])

    v0 = torch.tensor([float(getattr(base, f)) for f in FITTABLE_FIELDS],
                      dtype=torch.float32)
    return torch.autograd.functional.jacobian(metrics_of, v0).numpy()


@pytest.fixture(scope="module")
def ref_jacobian(golden):
    """``jax.jacfwd`` of the reference's evaluator over the fittable field
    values (jitted once, evaluated at any base point)."""
    spec, design, _, _ = golden

    def metrics_of(vals):
        out = ref_evaluate_system(spec, design,
                                  tech=_with(C.DEFAULT_TECH, vals))
        return jnp.stack([out[k] for k in METRIC_KEYS])

    jac = jax.jit(jax.jacfwd(metrics_of))
    return lambda base: np.asarray(jac(jnp.asarray(
        [float(getattr(base, f)) for f in FITTABLE_FIELDS], jnp.float32)))


def _golden_base(mod):
    return dataclasses.replace(mod.DEFAULT_TECH, t_tile_overhead_ns=8.0)


def _starved(mod):
    d = mod.DEFAULT_TECH
    return dataclasses.replace(
        d, t_tile_overhead_ns=8.0, dram_bw=d.dram_bw * 0.01,
        core_buf_bw=d.core_buf_bw * 0.01, chip_buf_bw=d.chip_buf_bw * 0.01,
        chip_noc_bw=d.chip_noc_bw * 0.01)


# ---------------------------------------------------------------------------
# differentiability
# ---------------------------------------------------------------------------
def test_jacobian_finite_and_mapped_fields_move(golden, ref_jacobian):
    """All four metrics have finite gradients w.r.t. every fittable field,
    each METRIC_FIELDS pair is non-zero on the golden design, and the
    jacobian is the reference's ``jax.jacfwd`` at rtol 1e-4."""
    _, _, spec, design = golden
    J = _jacobian(spec, design, _golden_base(tc))
    assert np.isfinite(J).all(), "non-finite metric gradient"
    for metric, fields in METRIC_FIELDS.items():
        row = J[METRIC_KEYS.index(metric)]
        for f in fields:
            assert row[FITTABLE_FIELDS.index(f)] != 0.0, \
                f"d {metric} / d {f} vanished on golden design"
    np.testing.assert_allclose(J, ref_jacobian(_golden_base(C.constants)),
                               rtol=1e-4, atol=0)


def test_metric_fields_cover_every_metric():
    for metric in METRIC_KEYS:
        assert metric in METRIC_FIELDS
        assert set(METRIC_FIELDS[metric]) <= set(FITTABLE_FIELDS)
    assert FITTABLE_FIELDS == REF_FITTABLE
    assert METRIC_FIELDS == REF_METRIC_FIELDS


def test_bandwidth_gradient_binds_when_starved(golden, ref_jacobian):
    """Starving the buffers makes ``core_buf_bw`` the bottleneck on the
    golden design — its gradient turns on, as the reference's does."""
    _, _, spec, design = golden
    J = _jacobian(spec, design, _starved(tc))
    assert np.isfinite(J).all()
    assert J[METRIC_KEYS.index("latency_ns"),
             FITTABLE_FIELDS.index("core_buf_bw")] != 0.0
    np.testing.assert_allclose(J, ref_jacobian(_starved(C.constants)),
                               rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# tech_key / cache identity
# ---------------------------------------------------------------------------
def test_tech_key_stable_across_equal_instances():
    a = TechConstants()
    b = dataclasses.replace(TechConstants())
    assert a is not b
    assert tech_key(a) == tech_key(b) == tech_key(DEFAULT_TECH)
    assert tech_key(a) == C.constants.tech_key(C.DEFAULT_TECH)


def test_tech_key_is_digest_not_repr():
    k = tech_key(DEFAULT_TECH)
    assert len(k) == 64 and all(c in "0123456789abcdef" for c in k)
    assert "TechConstants" not in k


def test_tech_key_distinguishes_calibrated():
    cal = dataclasses.replace(DEFAULT_TECH, corr_latency=1.01)
    assert tech_key(cal) != tech_key(DEFAULT_TECH)
    rt = tech_from_dict(tech_to_dict(cal))
    assert tech_key(rt) == tech_key(cal)


def test_session_cache_key_is_tech_aware(tmp_path):
    p = Problem(tp.bert_mms()["att2"], ch_max=2)
    s0 = Session(cache_dir=str(tmp_path / "a"), device="cpu")
    cal = dataclasses.replace(DEFAULT_TECH, corr_latency=1.25)
    s1 = Session(cache_dir=str(tmp_path / "b"), tech=cal, device="cpu")
    assert s0._cache_key(p) != s1._cache_key(p)
    s2 = Session(cache_dir=str(tmp_path / "c"), device="cpu")
    assert s0._cache_key(p) == s2._cache_key(p)


# ---------------------------------------------------------------------------
# default path bit-identity
# ---------------------------------------------------------------------------
def test_identity_corrections_are_bitwise_noops(golden):
    _, _, spec, design = golden
    explicit = dataclasses.replace(
        DEFAULT_TECH, t_tile_overhead_ns=0.0, corr_latency=1.0,
        corr_energy=1.0, corr_area=1.0, corr_cost=1.0)
    out0 = evaluate_system(spec, design, tech=DEFAULT_TECH)
    out1 = evaluate_system(spec, design, tech=explicit)
    for k in METRIC_KEYS:
        assert out0[k].numpy().tobytes() == out1[k].numpy().tobytes(), k


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------
def test_measurement_validation():
    with pytest.raises(ValueError):
        Measurement.make("bogus_kind", "latency_ns", 1.0, "x")
    with pytest.raises(ValueError):
        Measurement.make("system", "latency_ns", -1.0, "x")


def test_measurements_digest_order_insensitive():
    a = Measurement.make("system", "area_mm2", 216.0, "simba")
    b = Measurement.make("system", "cost_usd", 110.0, "simba")
    assert measurements_digest([a, b]) == measurements_digest([b, a])
    assert measurements_digest([a]) != measurements_digest([a, b])


def test_load_report_csv_and_json(tmp_path):
    csv = tmp_path / "r.csv"
    csv.write_text("kind,metric,value,source,pe_budget\n"
                   "system,area_mm2,216.0,simba,1024\n")
    ms = load_report(str(csv))
    assert len(ms) == 1 and ms[0].metric == "area_mm2"
    assert ms[0].info["pe_budget"] == 1024
    js = tmp_path / "r.json"
    js.write_text(json.dumps({"rows": [m.to_dict() for m in ms]}))
    ms2 = load_report(str(js))
    assert measurements_digest(ms2) == measurements_digest(ms)
    assert measurements_digest(ms) \
        == RC.measurements_digest(RC.load_report(str(csv)))


def test_sweeps_and_digests_equal_the_reference():
    got, ref = simulator_sweep(), RC.simulator_sweep()
    assert [m.to_dict() for m in got] == [m.to_dict() for m in ref]
    assert measurements_digest(got) == RC.measurements_digest(ref)
    got_b, ref_b = baseline_measurements(), RC.baseline_measurements()
    assert measurements_digest(got + got_b) \
        == RC.measurements_digest(ref + ref_b)


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------
def test_fit_reduces_simulator_error():
    train = simulator_sweep(shapes=[(64, 64, 64), (128, 128, 128)],
                            bws=(128.0,))
    held = simulator_sweep(shapes=[(100, 100, 100)], bws=(128.0,))
    res = fit(train, free=("t_tile_overhead_ns", "corr_latency"),
              holdout=held, steps=120, lr=0.05, seed=0, device="cpu")
    assert res.errors["train_after"]["mean"] \
        < res.errors["train_before"]["mean"]
    assert res.loss[1] < res.loss[0]
    assert set(res.fitted) == {"t_tile_overhead_ns", "corr_latency"}
    assert res.tech.t_tile_overhead_ns \
        == pytest.approx(res.fitted["t_tile_overhead_ns"])
    assert res.tech.e_mac_pj == DEFAULT_TECH.e_mac_pj


def test_fit_rejects_unknown_free_field():
    ms = simulator_sweep(shapes=[(64, 64, 64)], bws=(128.0,))
    with pytest.raises(ValueError):
        fit(ms, free=("not_a_field",), steps=1, device="cpu")


def test_error_report_keys():
    ms = simulator_sweep(shapes=[(64, 64, 64)], bws=(128.0,))
    rep = error_report(ms, DEFAULT_TECH, device="cpu")
    assert set(rep) == {"latency_ns", "mean"}
    assert rep["mean"] >= 0.0
    assert rep == pytest.approx(RC.error_report(
        RC.simulator_sweep(shapes=[(64, 64, 64)], bws=(128.0,)),
        C.DEFAULT_TECH), rel=1e-6)


def test_fit_defaults_to_the_card():
    ms = simulator_sweep(shapes=[(64, 64, 64)], bws=(128.0,))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for call in (lambda: fit(ms, steps=1), lambda: predict(ms),
                 lambda: error_report(ms)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_validation_split_fit_matches_the_reference():
    """The reference's bench_validation arm at 100 steps: the fitted
    constants within rtol 1e-3, the held-out error within 1e-4."""
    free = ("t_tile_overhead_ns", "corr_latency")
    kw = dict(free=free, steps=100, lr=0.05, seed=0)
    got = fit(simulator_sweep(shapes=SHAPES[:6], bws=BWS),
              holdout=simulator_sweep(shapes=SHAPES[6:], bws=BWS),
              device="cpu", **kw)
    ref = RC.fit(RC.simulator_sweep(shapes=SHAPES[:6], bws=BWS),
                 holdout=RC.simulator_sweep(shapes=SHAPES[6:], bws=BWS),
                 **kw)
    for f in free:
        assert got.fitted[f] == pytest.approx(ref.fitted[f], rel=1e-3)
    for split in ("holdout_before", "holdout_after"):
        assert got.errors[split]["mean"] == pytest.approx(
            ref.errors[split]["mean"], abs=1e-4)
    assert got.loss == pytest.approx(ref.loss, rel=1e-3)
    assert got.source_digest == ref.source_digest


def _carry_reference_baselines(monkeypatch):
    """The port's ``make_baseline`` answering with the reference's design
    (drawn from ``PRNGKey(seed)``), so both packages predict one design."""
    from repro.core.baselines import make_baseline as ref_make

    def carried(name, spec, key, pe_budget=4096, device="cuda"):
        ref_spec = C.SystemSpec.build(C.presets.fig7_suite()[
            _graph_name(spec)], ch_max=spec.CH)
        bl = ref_make(name, ref_spec, jax.random.PRNGKey(int(key)),
                      pe_budget=pe_budget)
        return port_baselines.Baseline(
            bl.name, None, convert.design_to_torch(bl.init, device=device),
            sa_fields=bl.sa_fields, bo_fields=bl.bo_fields)

    monkeypatch.setattr(port_baselines, "make_baseline", carried)


def _graph_name(spec):
    sig = [w.name for w in spec.graph.workloads]
    for name, g in tp.fig7_suite().items():
        if [w.name for w in g.workloads] == sig:
            return name
    raise KeyError(sig)


def test_system_rows_match_the_reference_design_carried(monkeypatch):
    _carry_reference_baselines(monkeypatch)
    ms = baseline_measurements()
    cal = dataclasses.replace(DEFAULT_TECH, corr_area=1.5, corr_cost=0.75)
    got = predict(ms, cal, device="cpu")
    ref_tech = dataclasses.replace(C.DEFAULT_TECH, corr_area=1.5,
                                   corr_cost=0.75)
    ref_pred = ref_build_predictor(RC.baseline_measurements())
    ref = np.asarray(jax.jit(lambda: ref_pred(ref_tech))())
    np.testing.assert_allclose(got, ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# CalibratedTech artifact lifecycle
# ---------------------------------------------------------------------------
def _small_fit():
    train = simulator_sweep(shapes=[(64, 64, 64)], bws=(128.0,))
    return fit(train, free=("t_tile_overhead_ns", "corr_latency"),
               holdout=train, steps=40, lr=0.05, seed=0, device="cpu")


def test_calibrated_tech_round_trip(tmp_path):
    res = _small_fit()
    art = CalibratedTech.from_fit("t_roundtrip", res)
    path = art.save(str(tmp_path))
    loaded = load_calibrated(path)
    assert loaded.digest == art.digest == tech_key(res.tech)
    assert tech_key(loaded.tech) == tech_key(res.tech)
    assert loaded.free == art.free


def test_calibrated_tech_tamper_detected(tmp_path):
    res = _small_fit()
    art = CalibratedTech.from_fit("t_tamper", res)
    path = art.save(str(tmp_path))
    doc = json.loads(open(path).read())
    doc["tech"]["corr_latency"] = 2.0
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(ValueError):
        load_calibrated(path)


def test_artifacts_load_across_the_packages(tmp_path):
    port_art = CalibratedTech.from_fit("x_port", _small_fit())
    p_path = port_art.save(str(tmp_path / "port"))
    ref_res = RC.fit(RC.simulator_sweep(shapes=[(64, 64, 64)],
                                        bws=(128.0,)),
                     free=("t_tile_overhead_ns", "corr_latency"),
                     holdout=[], steps=5)
    ref_art = RC.CalibratedTech.from_fit("x_ref", ref_res)
    r_path = ref_art.save(str(tmp_path / "ref"))
    got = load_calibrated(r_path)           # reference-written, port-read
    assert got.digest == ref_art.digest and got.fitted == ref_art.fitted
    back = RC.load_calibrated(p_path)       # port-written, reference-read
    assert back.digest == port_art.digest and back.free == port_art.free
    for path, loader in ((r_path, load_calibrated),
                         (p_path, RC.load_calibrated)):
        doc = json.loads(open(path).read())
        doc["tech"]["a_pe"] = 9.0
        open(path, "w").write(json.dumps(doc))
        with pytest.raises(ValueError, match="digest mismatch"):
            loader(path)


def test_resolve_tech_accepts_artifact(tmp_path):
    res = _small_fit()
    art = CalibratedTech.from_fit("t_resolve", res)
    name, tech = tp.resolve_tech(art)
    assert name == "t_resolve"
    assert tech_key(tech) == tech_key(res.tech)
    label = tp.tech_label(art)
    assert label.startswith("t_resolve@") and len(label.split("@")[1]) == 12


def test_query_carries_tech_name(tmp_path, monkeypatch):
    """A query names its calibrated tech; the session resolves the name
    through ``$REPRO_CALIB_DIR`` to the artifact's constants."""
    art = CalibratedTech.from_fit("t_byname", _small_fit())
    art.save(str(tmp_path / "calib"))
    monkeypatch.setenv("REPRO_CALIB_DIR", str(tmp_path / "calib"))
    q = Query(Problem(tp.bert_mms()["att2"], ch_max=2), budget=64,
              tech="t_byname")
    assert q.tech == "t_byname"
    s = Session(cache_dir=str(tmp_path / "c"), device="cpu")
    sub = s._session_for(q.tech)
    assert sub is not s and tech_key(sub.tech) == art.digest
    assert sub.tech_label == f"t_byname@{art.digest[:12]}"


def test_fit_cli_writes_an_artifact(tmp_path, capsys):
    from repro_torch.calib.fit import main
    assert main(["--steps", "3", "--name", "cli_art", "--out",
                 str(tmp_path), "--device", "cpu",
                 "--free", "t_tile_overhead_ns,corr_latency"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "saved:" in out
    art = load_calibrated(str(tmp_path / "cli_art.json"))
    assert art.free == ("t_tile_overhead_ns", "corr_latency")


# ---------------------------------------------------------------------------
# script: a baseline-row fit on both packages
# ---------------------------------------------------------------------------
def baseline_fit_readings(steps: int = 400):
    """The published baseline rows under ``DEFAULT_FREE`` (seed-0 holdout
    split): the reference's fit, the port's with its own baseline designs,
    and the port's with the reference's designs carried across."""
    ref = RC.fit(RC.baseline_measurements(), steps=steps)
    own = fit(baseline_measurements(), steps=steps, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _carry_reference_baselines(mp)
        carried = fit(baseline_measurements(), steps=steps, device="cpu")
    rows = {}
    for name, r in (("reference", ref), ("port_own_design", own),
                    ("port_carried_design", carried)):
        rows[name] = dict(fitted=r.fitted, loss=list(r.loss),
                          train_after=r.errors["train_after"]["mean"],
                          holdout_after=r.errors["holdout_after"].get("mean"))
    for name in ("port_own_design", "port_carried_design"):
        rows[name]["max_rel_vs_reference"] = max(
            abs(rows[name]["fitted"][f] / ref.fitted[f] - 1.0)
            for f in DEFAULT_FREE)
    return rows


if __name__ == "__main__":
    print(json.dumps(baseline_fit_readings(
        int(sys.argv[1]) if len(sys.argv) > 1 else 400), indent=1))
