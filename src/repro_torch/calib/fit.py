"""Gradient-descent calibration of TechConstants against measurements.

The port of ``repro.calib.fit``, on a device.  ``fit(measurements,
free=...)`` reparameterizes a whitelisted subset of :class:`TechConstants`
fields in log-space (positivity is structural, values floored at
``_FLOOR``), then minimizes the mean squared *log* error over the training
rows with full-batch Adam (the reference's beta1, beta2, eps and float32
bias corrections), in float32.  The reference runs its steps as one jitted
``lax.scan``; the port runs a Python loop of ``steps`` autograd steps, each
one forward and one backward in eager mode.  The model side of every
residual goes through the port's differentiable evaluation path:

* every ``chiplet_matmul`` row through ONE call of the batched
  ``analyze_chiplet`` (its leading batch dimension replaces ``jax.vmap``);
* every ``system`` row through ``evaluate_system``'s body
  (``evaluate_arrays``, the spec tensors moved to the device once), one
  call per frozen baseline design.

The backward is repeatable on the card: the tech fields reach the rows
through broadcasts (reduced in a fixed order), element-wise operations,
advanced indexing (its backward adds duplicates in sorted order) and the
evaluator's fixed-order sums — no atomic scatter-add, so two fits of the
same rows give the same constants and the same artifact digest.

CLI::

    PYTHONPATH=src python -m repro_torch.calib.fit --source simulator \\
        --free t_tile_overhead_ns,corr_latency --name sim28 \\
        --out artifacts/calib --device cpu

Obs surface (the reference's names): ``calib.fit_loss``,
``calib.error_before`` / ``calib.error_after`` histograms, a ``calib.fits``
counter, and a ``type="calib_fit"`` journal record per fit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.constants import (DEFAULT_TECH, FITTABLE_FIELDS, TechConstants,
                              tech_key)
from ..core.dataflow import analyze_chiplet
from ..core.workload import MAX_LOOPS, matmul
from ..runtime import resolve_device
from .measurements import Measurement, measurements_digest

F = torch.float32

#: default free set: the additive per-tile overhead the pure pipeline model
#: omits plus the four per-metric corrections — enough to absorb systematic
#: scale error in every metric without disturbing model structure.
DEFAULT_FREE = ("t_tile_overhead_ns", "corr_latency", "corr_energy",
                "corr_area", "corr_cost")

#: log-space floor: fields whose current value is 0 (e.g. the overhead's
#: neutral default) start here instead of log(0).
_FLOOR = 1e-3

# Adam, as the reference's fit
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------------------
# measurement -> differentiable model prediction
# ---------------------------------------------------------------------------
def _chiplet_predictor(ms: Sequence[Measurement], dev):
    """Batched ``analyze_chiplet`` predictor for ``chiplet_matmul`` rows:
    every (M, N, K, bw) row is one entry of the batch dimension (workload
    arrays share their padded shapes).  Configuration as the reference's
    ``benchmarks/bench_validation``: one ax x ay core, chiplet tile = one
    output fold."""
    wls, tis, bws, shs = [], [], [], []
    for m in ms:
        info = m.info
        if m.metric != "latency_ns":
            raise ValueError(
                f"chiplet_matmul supports latency_ns only, got {m.metric!r}")
        M_, N_, K_ = int(info["M"]), int(info["N"]), int(info["K"])
        ax, ay = int(info.get("ax", 8)), int(info.get("ay", 8))
        wls.append(matmul("mm", M_, N_, K_).to_arrays())
        tis.append([[ax, ay, K_] + [1] * (MAX_LOOPS - 3)] * 2)
        bws.append(float(info.get("bw", 128.0)))
        shs.append([ax, ay, 1, 1, 1, 1])
    n = len(ms)
    wl_b = {k: torch.as_tensor(np.stack([w[k] for w in wls]), device=dev)
            for k in wls[0]}
    ti_b = torch.as_tensor(np.asarray(tis, np.int32), device=dev)
    sh_b = torch.as_tensor(np.asarray(shs, np.int32), device=dev)
    bw_b = torch.as_tensor(np.asarray(bws, np.float32), device=dev)
    sp_b = torch.as_tensor(np.tile(np.asarray([0, 1, 0, 1, 0, 1], np.int32),
                                   (n, 1)), device=dev)
    od_b = torch.as_tensor(np.tile(np.arange(MAX_LOOPS, dtype=np.int32),
                                   (n, 3, 1)), device=dev)

    def predict(tech):
        an = analyze_chiplet(wl_b, sh_b, sp_b, od_b, ti_b, tech,
                             ext_bw_gbps=bw_b)
        return an["delay_ns"] * tech.corr_latency

    return predict


def _system_predictor(ms: Sequence[Measurement], dev):
    """System-metric predictor for ``system`` rows sharing one frozen
    baseline configuration (graph, baseline, pe_budget, ch_max, seed).
    The baseline design comes from the port's ``make_baseline`` with the
    integer ``seed``, drawn on the CPU whatever ``dev`` is (a generator's
    stream depends on its device, so a fit on the card and one on the CPU
    predict the same design), then moved to ``dev``.  The reference draws
    from ``PRNGKey(seed)``: only the frozen geometry, spatial, packaging
    and family fields agree with its design."""
    from ..core import baselines
    from ..core.evaluate import SystemSpec, evaluate_arrays, spec_tensors
    from ..core.presets import fig7_suite

    info = ms[0].info
    graphs = fig7_suite()
    gname = str(info["graph"])
    if gname not in graphs:
        raise KeyError(f"unknown graph {gname!r}; known: {sorted(graphs)}")
    spec = SystemSpec.build(graphs[gname], ch_max=int(info.get("ch_max", 4)))
    bl = baselines.make_baseline(str(info.get("baseline", "monad")), spec,
                                 int(info.get("seed", 0)),
                                 pe_budget=int(info.get("pe_budget", 1024)),
                                 device="cpu")
    design = {k: v.to(dev)[None] for k, v in bl.init.items()}  # one design
    arr = spec_tensors(spec.arrays, dev)
    dims = (spec.W, spec.CH, spec.E)
    metrics = [m.metric for m in ms]

    def predict(tech):
        res = evaluate_arrays(arr, design, dims, tech)
        return torch.stack([res[k][0] for k in metrics])

    return predict


def _system_group_key(m: Measurement) -> tuple:
    info = m.info
    return ("system", str(info.get("graph")), str(info.get("baseline")),
            int(info.get("pe_budget", 1024)), int(info.get("ch_max", 4)),
            int(info.get("seed", 0)))


def _build_predictor(ms: Sequence[Measurement], dev):
    """Predictor over a mixed measurement list: ``predict(tech) -> (n,)``
    float32 tensor on ``dev``, aligned with ``ms`` order."""
    groups: Dict[tuple, Tuple[List[Measurement], List[int]]] = {}
    for i, m in enumerate(ms):
        gk = (("chiplet",) if m.kind == "chiplet_matmul"
              else _system_group_key(m))
        groups.setdefault(gk, ([], []))
        groups[gk][0].append(m)
        groups[gk][1].append(i)
    preds, order = [], []
    for gk, (gms, idx) in groups.items():
        preds.append(_chiplet_predictor(gms, dev) if gk[0] == "chiplet"
                     else _system_predictor(gms, dev))
        order.extend(idx)
    # the groups' outputs concatenate in group order; this permutation puts
    # them back in ``ms`` order
    back = torch.as_tensor(np.argsort(np.asarray(order)), device=dev)

    def predict(tech):
        return torch.cat([p(tech) for p in preds])[back]

    return predict


def _tech_with(tech0: TechConstants, theta: Dict[str, torch.Tensor]
               ) -> TechConstants:
    return dataclasses.replace(
        tech0, **{k: torch.exp(v) for k, v in theta.items()})


def predict(ms: Sequence[Measurement], tech: TechConstants = DEFAULT_TECH,
            device="cuda") -> np.ndarray:
    """Model predictions for a measurement list under ``tech`` (n,), run
    on ``device``."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _build_predictor(ms, dev)(tech).cpu().numpy()


def error_report(ms: Sequence[Measurement],
                 tech: TechConstants = DEFAULT_TECH,
                 pred: Optional[np.ndarray] = None,
                 device="cuda") -> Dict[str, float]:
    """Per-metric mean relative error |pred - meas| / meas, plus ``mean``
    (predictions run on ``device`` unless ``pred`` is given)."""
    if not ms:
        return {}
    p = predict(ms, tech, device=device) if pred is None else np.asarray(pred)
    meas = np.asarray([m.value for m in ms])
    rel = np.abs(p - meas) / meas
    out = {}
    for metric in sorted({m.metric for m in ms}):
        sel = np.asarray([m.metric == metric for m in ms])
        out[metric] = float(np.mean(rel[sel]))
    out["mean"] = float(np.mean(rel))
    return out


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FitResult:
    """A completed calibration fit: fitted constants + provenance + errors."""
    tech: TechConstants
    tech0: TechConstants
    free: Tuple[str, ...]
    fitted: Dict[str, float]           # field -> fitted value
    errors: Dict[str, Dict[str, float]]  # split -> per-metric relative error
    loss: Tuple[float, float]          # (initial, final) train loss
    n_train: int
    n_holdout: int
    steps: int
    lr: float
    seed: int
    source_digest: str
    sources: Tuple[str, ...]

    @property
    def digest(self) -> str:
        return tech_key(self.tech)


def fit(measurements: Sequence[Measurement],
        free: Sequence[str] = DEFAULT_FREE,
        holdout: Optional[Sequence[Measurement]] = None,
        holdout_frac: float = 0.25,
        steps: int = 400,
        lr: float = 0.05,
        seed: int = 0,
        tech0: TechConstants = DEFAULT_TECH,
        device="cuda") -> FitResult:
    """Fit ``free`` TechConstants fields to ``measurements`` on ``device``
    (default ``"cuda"``; without a card it raises unless ``device="cpu"``).

    ``holdout`` pins an explicit held-out set (the bench_validation gate
    splits by shape); otherwise a deterministic ``holdout_frac`` split of
    ``measurements`` is used (the reference's numpy permutation).  Returns
    a :class:`FitResult` whose ``errors`` dict reports per-metric mean
    relative error for ``train_before/after`` and
    ``holdout_before/after``."""
    free = tuple(free)
    bad = set(free) - set(FITTABLE_FIELDS)
    if bad:
        raise ValueError(f"non-whitelisted fit fields: {sorted(bad)}; "
                         f"allowed: {FITTABLE_FIELDS}")
    if not measurements:
        raise ValueError("no measurements")
    dev = resolve_device(device)

    if holdout is None:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(measurements))
        n_hold = int(round(len(measurements) * holdout_frac))
        hold_i = set(perm[:n_hold].tolist())
        train = [m for i, m in enumerate(measurements) if i not in hold_i]
        hold = [m for i, m in enumerate(measurements) if i in hold_i]
    else:
        train, hold = list(measurements), list(holdout)
    if not train:
        raise ValueError("empty training split")

    all_ms = train + hold
    with obs.span("calib.fit", n_train=len(train), n_holdout=len(hold),
                  free=",".join(free), steps=steps):
        predict_fn = _build_predictor(all_ms, dev)
        n_train = len(train)
        log_meas = torch.log(torch.as_tensor(
            [m.value for m in train], dtype=F, device=dev))

        theta = {f: torch.log(torch.as_tensor(
            getattr(tech0, f), dtype=F, device=dev).clamp_min(_FLOOR)
        ).requires_grad_(True) for f in free}
        m1 = {f: torch.zeros_like(v) for f, v in theta.items()}
        m2 = {f: torch.zeros_like(v) for f, v in theta.items()}
        b1 = torch.tensor(_B1, dtype=F, device=dev)
        b2 = torch.tensor(_B2, dtype=F, device=dev)
        losses = []
        for t in range(steps):
            pred = predict_fn(_tech_with(tech0, theta))
            r = torch.log(pred[:n_train].clamp_min(1e-9)) - log_meas
            loss = torch.mean(r * r)
            # a field no training row depends on gets a zero gradient
            grads = torch.autograd.grad(loss, [theta[f] for f in free],
                                        allow_unused=True,
                                        materialize_grads=True)
            losses.append(loss.detach())
            step = torch.tensor(t + 1, dtype=F, device=dev)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for f, g in zip(free, grads):
                    m1[f] = _B1 * m1[f] + (1 - _B1) * g
                    m2[f] = _B2 * m2[f] + (1 - _B2) * g ** 2
                    theta[f] -= lr * (m1[f] / c1) / (
                        torch.sqrt(m2[f] / c2) + _EPS)

        fitted = {f: float(np.exp(theta[f].detach().cpu().numpy()))
                  for f in free}
        tech_fit = dataclasses.replace(tech0, **fitted)

        with torch.no_grad():
            pred0 = predict_fn(tech0).cpu().numpy()
            pred1 = predict_fn(tech_fit).cpu().numpy()
        errors = {
            "train_before": error_report(train, tech0, pred0[:n_train]),
            "train_after": error_report(train, tech_fit, pred1[:n_train]),
            "holdout_before": error_report(hold, tech0, pred0[n_train:]),
            "holdout_after": error_report(hold, tech_fit, pred1[n_train:]),
        }
        if losses:
            loss_i, loss_f = (float(v) for v in torch.stack(
                [losses[0], losses[-1]]).cpu())
        else:
            loss_i = loss_f = float("nan")

        obs.inc("calib.fits")
        obs.observe("calib.fit_loss", loss_f)
        obs.observe("calib.error_before",
                    errors["train_before"].get("mean", 0.0))
        obs.observe("calib.error_after",
                    errors["train_after"].get("mean", 0.0))
        result = FitResult(
            tech=tech_fit, tech0=tech0, free=free, fitted=fitted,
            errors=errors, loss=(loss_i, loss_f),
            n_train=n_train, n_holdout=len(hold), steps=steps, lr=lr,
            seed=seed, source_digest=measurements_digest(all_ms),
            sources=tuple(sorted({m.source for m in all_ms})))
        obs.emit({"type": "calib_fit", "free": list(free),
                  "fitted": fitted, "errors": errors,
                  "loss": [loss_i, loss_f], "n_train": n_train,
                  "n_holdout": len(hold), "steps": steps, "lr": lr,
                  "seed": seed, "source_digest": result.source_digest,
                  "tech_digest": result.digest})
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import os

    from .measurements import (baseline_measurements, load_report,
                               simulator_sweep)
    from .preset import CalibratedTech

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calib.fit",
        description="Fit TechConstants to measured ground truth.")
    ap.add_argument("--source", action="append", default=[],
                    help="'simulator', 'baselines', or a report path "
                         "(.csv/.json); repeatable; default: simulator")
    ap.add_argument("--free", action="append", default=[],
                    help="TechConstants field to fit; repeatable, each "
                         "occurrence may also be comma-separated "
                         f"(default: {','.join(DEFAULT_FREE)})")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--holdout-frac", type=float, default=0.25)
    ap.add_argument("--name", default="calibrated",
                    help="preset name for the saved artifact")
    ap.add_argument("--out", default=os.environ.get("REPRO_CALIB_DIR",
                                                    "artifacts/calib"),
                    help="output directory for the CalibratedTech JSON")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    ms: List[Measurement] = []
    for src in (args.source or ["simulator"]):
        if src == "simulator":
            ms += simulator_sweep()
        elif src == "baselines":
            ms += baseline_measurements()
        else:
            ms += load_report(src)
    free = tuple(f.strip() for part in (args.free or [",".join(DEFAULT_FREE)])
                 for f in part.split(",") if f.strip())

    res = fit(ms, free=free, holdout_frac=args.holdout_frac,
              steps=args.steps, lr=args.lr, seed=args.seed,
              device=args.device)

    art = CalibratedTech.from_fit(args.name, res)
    path = art.save(args.out)

    print(f"fit: {len(ms)} measurements "
          f"({res.n_train} train / {res.n_holdout} held out), "
          f"free={','.join(free)}, device={args.device}")
    for f, v in res.fitted.items():
        print(f"  {f}: {getattr(res.tech0, f)} -> {v:.6g}")
    for split in ("train", "holdout"):
        b = res.errors[f"{split}_before"].get("mean")
        a = res.errors[f"{split}_after"].get("mean")
        if b is not None:
            print(f"  {split}: mean rel err {b*100:.2f}% -> {a*100:.2f}%")
    print(f"saved: {path} (preset '{args.name}', digest "
          f"{art.digest[:12]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
