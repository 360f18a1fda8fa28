"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; none is skipped):

1. the card: ``torch.cuda.get_device_name(0)`` and the name and power limit
   as ``nvidia-smi`` reports them;
2. build every kernel of the main path from its sources, all ``nvcc``
   processes started together, and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge cases (exact equality for the integer
   dominance counts), timed with CUDA events;
4. the evaluator's golden metric vectors on the card (rtol 1e-4);
5. the main path, cold: ``Session.submit`` of the default query on the
   paper's Fig. 4a transformer block — budget 2048, pop 64, ``ch_max=4``,
   archive capacity 256, objectives (latency, cost) — with every kernel's
   launch count set to 0 just before and read just after;
6. the same query again from a fresh session on the same cache directory:
   served from cache, identical front, no evaluations;
7. where the main path's time goes: one 8-generation segment timed on the
   host clock, one population evaluation timed with CUDA events, and the
   device time and kernel counts of both from ``torch.profiler`` (reported
   as not measured if the profiler sees no device events).

The last lines are the kernels JSON line, the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import Problem, Query, Session  # noqa: E402
from repro_torch.core import presets  # noqa: E402
from repro_torch.core.encoding import (DesignSpace,  # noqa: E402
                                       feasibility_penalty, random_design)
from repro_torch.core.evaluate import (SystemSpec,  # noqa: E402
                                       evaluate_system, make_batch_evaluator)
from repro_torch.core.optimizer import METRIC_KEYS, metric_stack  # noqa: E402
from repro_torch.core.workload import MAX_LOOPS  # noqa: E402
from repro_torch.explore.archive import HV_LOG_REF, hypervolume_2d  # noqa: E402
from repro_torch.explore.nsga import NSGAConfig, make_nsga  # noqa: E402
from repro_torch.kernels.pareto_rank import ops as pareto_ops  # noqa: E402
from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

# (latency_ns, energy_pj, cost_usd, area_mm2) of the fixed golden design
# under the default tech — the values tests/test_golden_metrics.py pins
GOLDEN = {
    "att2": (92995704.0, 20249282560.0,
             9.310935020446777, 3.136559009552002),
    "res2": (1272764416.0, 278478028800.0,
             9.310935020446777, 3.136559009552002),
    "transformer_block": (3324772864.0, 459914838016.0,
                          26.559057235717773, 15.82420825958252),
}

# pareto_rank checks: (n, k, valid fraction, tag); the first three are the
# main path's pools (NSGA selection over 2 x pop, the per-generation front
# telemetry over pop, archive insert over capacity + pop x chunk)
PARETO_SHAPES = ((128, 2, 1.0, "selection"), (64, 2, 0.9, "telemetry"),
                 (768, 4, 1.0, "archive insert"),
                 (190, 3, 0.9, "ragged"), (8192, 4, 0.8, "large, ties"),
                 (256, 4, 0.0, "all invalid"))


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def pareto_bound_ms(n: int, k: int) -> tuple:
    """Least time for one dominance count: n*(4k+1) bytes read and 4n
    written at the memory rate, or n^2 pairs x 2k FP32 compares at the
    FP32 rate, whichever is larger."""
    t_bytes = (n * (4 * k + 1) + 4 * n) / PEAK_BYTES_PER_S * 1e3
    t_ops = n * n * 2 * k / PEAK_FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_pareto_rank() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n, k, frac, tag in PARETO_SHAPES:
        objs = torch.randn(n, k, generator=gen, device="cuda")
        dup = min(16, n // 4)
        objs[n // 2:n // 2 + dup] = objs[:dup]      # exact ties
        valid = torch.rand(n, generator=gen, device="cuda") < frac
        got = pareto_ops.dominance_counts(objs, valid)
        torch.cuda.synchronize()
        want = dominance_counts_ref(objs, valid)
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            fail(f"pareto_rank disagrees with its plain version at "
                 f"({n}, {k}): max abs err {err}")
        if frac == 0.0 and int(got.sum()) != 0:
            fail("pareto_rank counted dominators in an all-invalid pool")
        iters = 200 if n <= 1024 else 50
        k_ms = cuda_ms(lambda: pareto_ops.dominance_counts(objs, valid),
                       iters)
        p_ms = cuda_ms(lambda: dominance_counts_ref(objs, valid),
                       max(iters // 4, 10))
        b_ms, b_by = pareto_bound_ms(n, k)
        rows.append(dict(n=n, k=k, valid_frac=frac, tag=tag, exact=True,
                         max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"pareto_rank ({n}, {k}) {tag}: exact, kernel {k_ms * 1e3:.2f}"
              f" us, plain {p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.4f} us "
              f"({b_by})")
    return rows


def golden_design(spec):
    W, CH, L = spec.W, spec.CH, MAX_LOOPS
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    return dict(
        shape=t(np.tile([4, 4, 2, 2, 1, 2], (1, W, 1))),
        spatial=t(np.zeros((1, W, 6))),
        order=t(np.tile(np.arange(L), (1, W, 3, 1))),
        tiling=t(np.ones((1, W, 2, L))),
        pipe=t(np.full((1, W), L)),
        logB=t([0]), packaging=t([1]), family=t([2]),
        placement=t(np.arange(W * CH)[None]))


def check_golden():
    graphs = dict(att2=presets.bert_mms()["att2"],
                  res2=presets.resnet_convs()["res2"],
                  transformer_block=presets.transformer_block())
    for name, want in GOLDEN.items():
        spec = SystemSpec.build(graphs[name], ch_max=2)
        design = golden_design(spec)
        m = evaluate_system(spec, design)
        got = metric_stack(m)[0].double().cpu().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   err_msg=f"golden {name} {METRIC_KEYS}")
        pen = float(feasibility_penalty(DesignSpace(spec), design)[0])
        if abs(pen - 1.0) > 1e-6:
            fail(f"golden design {name} is not feasible (penalty {pen})")
        print(f"golden {name}: {got.tolist()} within rtol 1e-4")


def front_hv(front_objs) -> float:
    return hypervolume_2d(np.log(np.maximum(front_objs, 1e-3)),
                          (HV_LOG_REF, HV_LOG_REF))


def check_front(problem, result):
    fr = result.front_objs
    if fr.shape[0] == 0 or fr.shape[1] != 2 or not np.all(np.isfinite(fr)):
        fail(f"bad front {fr.shape}")
    designs = {k: torch.as_tensor(np.stack([d[k] for d in
                                            result.front_designs]),
                                  device="cuda")
               for k in result.front_designs[0]}
    m = evaluate_system(problem.spec, designs)
    pen = feasibility_penalty(problem.space, designs, m)
    if float(pen.max()) > 1.0 + 1e-6:
        fail("the served front holds an infeasible design")
    again = metric_stack(m).double().cpu().numpy()
    np.testing.assert_allclose(again, result.front_metrics, rtol=1e-5,
                               err_msg="front metrics do not re-evaluate")


def breakdown(problem) -> dict:
    """Where one default-width segment's time goes (pop 64, 8 generations,
    the service's default chunk)."""
    gens = 8
    run = make_nsga(problem.spec, problem.space, problem.objectives,
                    NSGAConfig(pop=64, generations=gens), device="cuda")
    pop0 = random_design(0, problem.space, n=64, device="cuda")
    run(1, pop0)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(2, pop0)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    evaluate = make_batch_evaluator(problem.spec, device="cuda")
    eval_ms = cuda_ms(lambda: evaluate(pop0), 10)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(3, pop0)
        torch.cuda.synchronize()
    def device_kernels(prof):
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in dev) * 1e-6,
                sum(e.count for e in dev))

    device_s, n_kernels = device_kernels(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        evaluate(pop0)
        torch.cuda.synchronize()
    eval_device_s, eval_kernels = device_kernels(prof)
    out = dict(segment_s=seg_s, generations=gens,
               generation_ms=seg_s / gens * 1e3, evaluate_ms=eval_ms,
               evaluate_share=eval_ms * gens / (seg_s * 1e3))
    print(f"breakdown: {gens} generations in {seg_s * 1e3:.1f} ms "
          f"({out['generation_ms']:.2f} ms each); one evaluation of 64 "
          f"designs {eval_ms:.2f} ms ({out['evaluate_share']:.1%} of the "
          f"segment)")
    if device_s <= 0 or eval_device_s <= 0:
        # the profiler traced no device events on this machine: the
        # device-side numbers are not measured, never guessed
        print("breakdown: device time not measured (the profiler saw no "
              "device events)")
        return out
    out.update(device_s=device_s, device_busy_share=device_s / seg_s,
               kernels_per_generation=n_kernels / gens,
               kernels_per_evaluation=eval_kernels,
               evaluate_device_ms=eval_device_s * 1e3)
    print(f"breakdown: one evaluation launches {eval_kernels} kernels, "
          f"{eval_device_s * 1e3:.2f} ms device time; device busy "
          f"{device_s * 1e3:.2f} ms = {out['device_busy_share']:.1%} of the "
          f"segment; {out['kernels_per_generation']:.0f} kernels per "
          f"generation")
    return out


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")

    # ---- 2. build every kernel, one nvcc each, all started together -------
    t0 = time.perf_counter()
    builds = {"pareto_rank": pareto_ops.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = {name: f.result() for name, f in
                [(n, pool.submit(b)) for n, b in builds.items()]}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions ---------------------------
    pareto_rows = check_pareto_rank()

    # ---- 4. evaluator golden vectors --------------------------------------
    check_golden()

    # ---- 5. the main path, cold --------------------------------------------
    problem = Problem(presets.transformer_block(), ("latency_ns", "cost_usd"),
                      ch_max=4)
    query = Query(problem, budget=2048)
    with tempfile.TemporaryDirectory() as cache:
        pareto_ops.dominance_counts.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = Session(cache_dir=cache, device="cuda").submit(query)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = pareto_ops.dominance_counts.launches
        pv = cold.provenance
        if pv.from_cache or pv.n_evals_run <= 0:
            fail(f"cold query spent no evaluations: {pv}")
        gens = cold.trace.generations
        segs = len(cold.trace.archive_hv)
        if launches < gens + segs:
            fail(f"pareto_rank launched {launches} times for {gens} "
                 f"generations and {segs} segments")
        check_front(problem, cold)
        hv = front_hv(cold.front_objs)
        print(f"cold query: {pv.n_evals_run} evaluations in {cold_s:.3f} s "
              f"({pv.n_evals_run / cold_s:.1f} evaluations/s), {gens} "
              f"generations in {segs} segments, front {len(cold.front_objs)}"
              f" points, log-space hypervolume {hv:.6f}, pareto_rank "
              f"launches {launches}")

        # ---- 6. warm: the same query from a fresh session ------------------
        before = pareto_ops.dominance_counts.launches
        t0 = time.perf_counter()
        warm = Session(cache_dir=cache, device="cuda").submit(query)
        warm_s = time.perf_counter() - t0
        if not warm.provenance.from_cache or warm.provenance.n_evals_run:
            fail(f"warm query was not served from cache: {warm.provenance}")
        if not np.array_equal(warm.front_objs, cold.front_objs):
            fail("warm front differs from the cold front")
        print(f"warm query: from cache in {warm_s * 1e3:.2f} ms, identical "
              f"front, 0 evaluations, {pareto_ops.dominance_counts.launches - before}"
              f" kernel launches")

    # ---- 7. where the time goes --------------------------------------------
    split = breakdown(problem)

    main_row = next(r for r in pareto_rows if r["tag"] == "archive insert")
    record = dict(
        name="pareto_rank", route="cuda",
        source="src/repro_torch/kernels/pareto_rank/csrc/pareto_rank.cu",
        replaces="src/repro/kernels/pareto_rank/pareto_rank.py:41",
        launches=launches, max_abs_err=max(r["max_abs_err"]
                                           for r in pareto_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, exact=True,
        kernel_us=main_row["ms"] * 1e3, plain_us=main_row["plain_ms"] * 1e3,
        bound_us=main_row["bound_ms"] * 1e3, shapes=pareto_rows,
        main_path=dict(cold_s=cold_s, warm_s=warm_s,
                       evals=pv.n_evals_run,
                       evals_per_s=pv.n_evals_run / cold_s,
                       generations=gens, segments=segs,
                       front_size=int(len(cold.front_objs)), hv=hv,
                       breakdown=split))
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
