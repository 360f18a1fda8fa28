"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; none is skipped):

1. the card: ``torch.cuda.get_device_name(0)`` and the name and power limit
   as ``nvidia-smi`` reports them;
2. build every kernel of the driven paths from its sources (``pareto_rank``,
   ``gp_cov``, ``flash_attention`` — its float32 SIMT kernel and its
   bfloat16 tensor-core kernel in one library — and ``mamba_scan``), all
   ``nvcc`` processes started together; print the build seconds, the
   ``-Xptxas -v`` report of the attention and scan kernels (registers,
   shared memory, spills, per instantiation: the attention kernels' padded
   head dims (PD, PV), 192 / 128 for MLA; a scan kernel that spills fails
   the run) and,
   where ``cuobjdump`` is installed, the count of ``HGMMA`` instructions in
   the attention library (none fails the run);
3. hold each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at edge cases (exact equality for the integer
   dominance counts, max abs error <= 1e-5 for the covariance; for
   attention the reference kernel test's tolerances, 2e-5 in float32 and
   2e-2 in bfloat16, atol and rtol, with bfloat16 at the serving shapes
   held to about one bf16 rounding, atol 4e-3 and rtol 8e-3, and every
   bfloat16 call counted as one tensor-core launch, every float32 call as
   none; 1e-4 for the scan, also with Hymba's A = -(1..16) and at ragged
   shapes, and two calls bitwise equal), timed with CUDA events beside the
   least time the card could take (and, for attention, beside
   ``scaled_dot_product_attention``, also at MLA's head dims D 192 / Dv
   128; for the scan, beside its floor on the special-function units and
   with the split of its launch; for ``pareto_rank`` — also on pools with
   NaN and +-inf objectives — and ``gp_cov``, the device time per launch
   from ``torch.profiler`` beside the wrapper's time per call, and an
   issue floor: the instructions a pair needs over the card's FP32 lanes
   at the max SM clock);
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
   as not measured if the profiler sees no device events);
8. the README's quickstart query, the paper's own engine:
   ``Query(engine="bo_sa", weights=OBJ_EDP)`` on the Fig. 4a transformer
   block with ``ch_max=6``, a 4096-PE budget, ``n_init=4``, ``n_iter=8``
   and ``SAConfig(steps=250, chains=4)`` — 12 SA runs, 2 ``gp_cov``
   launches per BO iteration — with the kernels' counts set to 0 just
   before and read just after; the best design re-evaluates to its
   metrics and objective and its feasibility penalty is printed (see
   ``check_best``), the convergence trace is finite and
   non-increasing; then one SA step, one BO acquisition and the device
   share of a short SA run, timed on their own;
9. ``two_stage`` on the same problem with ``SAConfig(steps=10, chains=4)``
   (a cut of the SA steps only) and a ``ParetoArchive`` passed as
   ``Query.archive``: ``gp_cov`` at d = 60 and d = 2, ``pareto_rank`` on
   every archive insert, and the returned front checked against the
   archive;
10. the LM serving slice on the card against the CPU: ``hymba-1.5b`` at
    full width cut to 2 layers, in float32, one seeded weight set on both
    devices, batch 1, a 1024-token prompt (1152 positions with the meta
    tokens, so the 1024 window binds): forward logits, prefill logits and
    4 greedy decode steps (logits and every cache leaf) within 1e-3, with
    the attention counts set to 0 just before and read just after (the
    float32 SIMT kernel: one launch per layer in the forward and in the
    prefill, no tensor-core launch);
11. the LM serving slice at full size: ``hymba-1.5b`` as configured (32
    layers, bfloat16 activations, float32 weights from a seed), batch 4,
    a 1024-token prompt, 32 generated tokens through
    ``launch.serve.generate``, with the kernels' counts set to 0 just
    before and read just after (exactly 32 ``flash_attention`` launches,
    all 32 on the tensor-core kernel, and 32 x 32 ``mamba_scan``
    launches); logits finite, a second run gives the same tokens; prefill
    seconds, decode ms per token, tokens/s, peak device memory, the device
    busy share and kernel count of one decode step, and the device-time
    split of one prefill by kernel from ``torch.profiler``, with the scan's
    device time per decode launch and in prefill.

The last lines are the kernels JSON line, the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import presets  # noqa: E402
from repro_torch.core.encoding import (DesignSpace,  # noqa: E402
                                       feasibility_penalty, random_design)
from repro_torch.core.evaluate import (SystemSpec,  # noqa: E402
                                       evaluate_system, make_batch_evaluator)
from repro_torch.core.optimizer import (METRIC_KEYS, OBJ_EDP,  # noqa: E402
                                        SAConfig, gp_posterior, make_sa,
                                        metric_stack, objective_from_metrics,
                                        prob_improvement)
from repro_torch.core.workload import MAX_LOOPS  # noqa: E402
from repro_torch.explore.archive import (HV_LOG_REF,  # noqa: E402
                                         ParetoArchive, hypervolume_2d,
                                         pareto_front)
from repro_torch.explore.nsga import NSGAConfig, make_nsga  # noqa: E402
from repro_torch.kernels.gp_cov import ops as gp_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.gp_cov.ref import matern52_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.model import HybridLM, build_model  # noqa: E402
from repro_torch.kernels.pareto_rank import ops as pareto_ops  # noqa: E402
from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12

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
# telemetry over pop, archive insert over capacity + pop x chunk).  The
# others cross the kernel's edges: its 128-row j tiles, its chunks of
# dominator rows (at least 64 rows, at most 8 a cluster) and the staged
# tiles' rounding to 4 rows; "nan/inf" pools hold NaN, +inf and -inf
# objectives (ties among them too)
PARETO_SHAPES = ((128, 2, 1.0, "selection"), (64, 2, 0.9, "telemetry"),
                 (768, 4, 1.0, "archive insert"),
                 (190, 3, 0.9, "ragged"), (8192, 4, 0.8, "large, ties"),
                 (256, 4, 0.0, "all invalid"),
                 (768, 4, 0.9, "nan/inf"), (4099, 2, 0.9, "nan/inf, large"),
                 (300, 3, 0.0, "nan/inf, all invalid"),
                 (1, 1, 1.0, "one row"), (65, 1, 0.7, "two chunks"),
                 (129, 4, 0.9, "j tile edge"), (513, 3, 0.9, "chunk edge"))


def pareto_instructions(k: int) -> int:
    """Instructions a pair on the kernel's path for finite tiles: k
    subtracts, k // 2 three-way ORs, a decrement and an add."""
    return k + k // 2 + 2


# gp_cov checks: (n, m, d, tag).  The BO engine builds K(X, X) and K(Z, X)
# for 512 candidates Z against the n <= n_init + n_iter - 1 observations X:
# d = 62 on the quickstart path (BO_FIELDS over 5 workloads), 60 and 2 in
# two_stage's stages 1 and 2
GP_SHAPES = ((16, 16, 4, "kernel test"), (32, 24, 7, "kernel test"),
             (64, 64, 12, "kernel test"),
             (11, 11, 62, "quickstart K(X, X)"),
             (512, 11, 62, "quickstart K(Z, X)"),
             (9, 9, 60, "two_stage 1 K(X, X)"),
             (512, 9, 60, "two_stage 1 K(Z, X)"),
             (5, 5, 2, "two_stage 2 K(X, X)"),
             (512, 5, 2, "two_stage 2 K(Z, X)"),
             (190, 130, 7, "ragged"), (64, 48, 1, "d = 1"),
             (100, 64, 62, "thin tile edge"), (513, 65, 62, "wide, m 65"),
             (130, 129, 33, "128 tile edge"), (256, 132, 62, "16-byte stores"),
             (4096, 4096, 62, "large"))
GP_LENGTHSCALES = (0.1, 0.3, 0.5, 2.0)
GP_TOL = 1e-5
# issue floor: a subtract and an FMA per feature, and an epilogue of about
# 25 instructions (square root, scale, exponential, polynomial) per pair
GP_EPILOGUE_INSTRUCTIONS = 25
# FP32 lanes of an SM
LANES_PER_SM = 128

# the README's quickstart query (examples/quickstart.py)
QUICK_OPTS = dict(n_init=4, n_iter=8)
QUICK_SA = SAConfig(steps=250, chains=4)
TWO_STAGE_SA = SAConfig(steps=10, chains=4)

# flash_attention checks: (B, Sq, Sk, H, KV, D, Dv, mask, window,
# kv_valid_len, tag).  The reference kernel test's FA_SHAPES
# (tests/test_kernels.py), two shapes with Dv != D, the Hymba prefill shape
# (prompt 1024 + 128 meta tokens, 25 query heads over 5 KV heads, window
# 1024), a ragged Sq = Sk = 1000, and a kv_valid_len that is not a
# multiple of the kernels' tiles
FA_PREFILL = (4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None,
              "hymba prefill")
FA_SHAPES = ((1, 32, 32, 4, 4, 16, 16, "causal", 0, None, "kernel test"),
             (2, 64, 64, 8, 2, 32, 32, "causal", 0, None, "kernel test"),
             (1, 64, 64, 4, 1, 64, 64, "window", 16, None, "kernel test"),
             (2, 32, 32, 4, 2, 16, 16, "none", 0, None, "kernel test"),
             (2, 8, 64, 4, 2, 16, 16, "causal", 0, 40, "kernel test"),
             (1, 16, 48, 2, 2, 8, 8, "none", 0, 33, "kernel test"),
             (1, 256, 256, 4, 2, 64, 32, "causal", 0, None, "Dv != D"),
             (2, 96, 160, 4, 1, 16, 64, "window", 48, 150, "Dv != D"),
             FA_PREFILL,
             (1, 1000, 1000, 25, 5, 64, 64, "window", 1024, None, "ragged"),
             (2, 200, 333, 25, 5, 64, 64, "causal", 0, 317, "kv_valid_len"),
             (1, 64, 64, 4, 4, 192, 128, "causal", 0, None, "MLA"),
             (1, 64, 128, 4, 4, 192, 128, "causal", 0, 100,
              "MLA kv_valid_len"),
             (1, 512, 512, 128, 128, 192, 128, "causal", 0, None,
              "deepseek-v2 width"),
             (1, 1024, 1024, 32, 8, 128, 128, "causal", 0, None,
              "head dim 128"))
# held to the serving tolerance (bf16) and timed
FA_SERVE_TAGS = ("hymba prefill", "ragged", "kv_valid_len",
                 "deepseek-v2 width")
# MLA's head dims (DeepSeek-V2: q/k 128 + 64 rope, v 128) and a head dim
# of 128 (32 query heads over 8 KV heads), timed too
FA_TIMED_TAGS = FA_SERVE_TAGS + ("MLA", "MLA kv_valid_len", "head dim 128")
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bfloat16 at the serving shapes: about one bf16 rounding of the output
# (atol, rtol), since 2e-2 is ~40% of a typical |out| there, where each
# output averages ~100-1000 values of v
FA_BF16_SERVE_TOL = (4e-3, 8e-3)
FA_SOURCES = "src/repro_torch/kernels/flash_attention/csrc/"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:90"

# mamba_scan checks: (B, S, Di, Ds, tag); each with and without h0.  The
# reference kernel test's MS_SHAPES, the Hymba prefill scan and a decode
# step (S = 1, h0 carried), the prefill scan with Hymba's own A = -(1..16)
# (``Mamba.reset``) in place of the random one, and ragged shapes that
# cross the kernel's block of 32 / G channels and its 32-step tile (Ds 1,
# 3 and 32: 4-byte copies, and four threads a channel)
MS_PREFILL = (4, 1152, 3200, 16, "hymba prefill")
MS_DECODE = (4, 1, 3200, 16, "hymba decode")
MS_HYMBA_A = (4, 1152, 3200, 16, "hymba prefill, A = -(1..16)")
MS_SHAPES = ((1, 16, 8, 4, "kernel test"), (2, 32, 16, 8, "kernel test"),
             (1, 64, 32, 16, "kernel test"), MS_PREFILL, MS_DECODE,
             MS_HYMBA_A, (1, 5, 33, 16, "ragged"), (2, 37, 70, 3, "ragged"),
             (1, 40, 64, 1, "ragged"), (3, 77, 130, 32, "ragged"))
MS_TOL = 1e-4
# special-function units per SM, each one exponential per clock
SFU_PER_SM = 16

# the LM serving slice (phases 10-11)
HYMBA = "hymba-1.5b"
LM_PARITY_TOL = 1e-3
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1024, 32


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


def issue_floor_ms(pairs: int, instructions_per_pair: int,
                   sm_clock_hz: float) -> float:
    """Least time to issue ``instructions_per_pair`` instructions for each
    of ``pairs`` pairs on every SM's LANES_PER_SM lanes at the max SM clock
    (a floor beside the bound, computed from the shape)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return (pairs * instructions_per_pair
            / (n_sm * LANES_PER_SM * sm_clock_hz) * 1e3)


def device_ms_per_launch(fn, kernel_name: str, calls: int = 20):
    """Mean device milliseconds per launch of the kernel whose name holds
    ``kernel_name``, over the launches torch.profiler records in ``calls``
    calls of ``fn`` (it may drop a record: the launch count itself is the
    wrappers' counter's job); None when the profiler sees no device
    events.  Fails if it sees device events but none of this kernel."""
    fn()
    torch.cuda.synchronize()
    by_name = device_by_kernel(lambda: [fn() for _ in range(calls)])[2]
    if not by_name:
        return None
    hits = [v for key, v in by_name.items() if kernel_name in key]
    launches = sum(c for _, c in hits)
    if launches == 0:
        fail(f"the profiler saw no {kernel_name} launch in {calls} calls")
    return sum(t for t, _ in hits) / launches * 1e3


def pareto_pool(n: int, k: int, frac: float, tag: str, gen):
    """A seeded pool with exact ties; "nan/inf" pools also hold NaN, +inf
    and -inf objectives, and ties among those rows."""
    objs = torch.randn(n, k, generator=gen, device="cuda")
    dup = min(16, n // 4)
    objs[n // 2:n // 2 + dup] = objs[:dup]          # exact ties
    if "nan/inf" in tag:
        pick = torch.rand(n, k, generator=gen, device="cuda")
        objs[pick < 0.05] = float("nan")
        objs[(pick >= 0.05) & (pick < 0.1)] = float("inf")
        objs[(pick >= 0.1) & (pick < 0.15)] = -float("inf")
        objs[n // 4:n // 4 + dup] = objs[:dup]
    valid = torch.rand(n, generator=gen, device="cuda") < frac
    return objs, valid


def check_pareto_rank(sm_clock_hz: float) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n, k, frac, tag in PARETO_SHAPES:
        objs, valid = pareto_pool(n, k, frac, tag, gen)
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
        call = lambda: pareto_ops.dominance_counts(objs, valid)
        k_ms = cuda_ms(call, iters)
        dev_ms = device_ms_per_launch(call, "rank_kernel")
        p_ms = cuda_ms(lambda: dominance_counts_ref(objs, valid),
                       max(iters // 4, 10))
        b_ms, b_by = pareto_bound_ms(n, k)
        rows.append(dict(n=n, k=k, valid_frac=frac, tag=tag, exact=True,
                         max_abs_err=err, ms=k_ms, device_ms=dev_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by))
        dev = ("not measured" if dev_ms is None
               else f"{dev_ms * 1e3:.3f} us")
        print(f"pareto_rank ({n}, {k}) {tag}: exact, wrapper "
              f"{k_ms * 1e3:.2f} us per call, device {dev} per launch, "
              f"plain {p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.4f} us "
              f"({b_by})")
        per_pair = pareto_instructions(k)
        floor_ms = issue_floor_ms(n * n, per_pair, sm_clock_hz)
        print(f"pareto_rank ({n}, {k}) issue floor {floor_ms * 1e3:.4f} us "
              f"({per_pair} instructions a pair at "
              f"{sm_clock_hz / 1e9:.3f} GHz)")
    return rows


def gp_bound_ms(n: int, m: int, d: int) -> tuple:
    """Least time for one covariance: 4 (n + m) d bytes read and 4 n m
    written at the memory rate, or n m (3 d + 15) FP32 operations at the
    FP32 rate, whichever is larger."""
    t_bytes = (4 * (n + m) * d + 4 * n * m) / PEAK_BYTES_PER_S * 1e3
    t_ops = n * m * (3 * d + 15) / PEAK_FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_gp_cov(sm_clock_hz: float) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for n, m, d, tag in GP_SHAPES:
        x1 = torch.rand(n, d, generator=gen, device="cuda")
        x2 = torch.rand(m, d, generator=gen, device="cuda")
        x2[:min(4, m)] = x1[:min(4, m)]              # coincident points
        err = 0.0
        for ls in GP_LENGTHSCALES:
            got = gp_ops.matern52(x1, x2, ls)
            torch.cuda.synchronize()
            e = float((got - matern52_ref(x1, x2, ls)).abs().max())
            if not e <= GP_TOL:
                fail(f"gp_cov disagrees with its plain version at ({n}, {m},"
                     f" {d}), lengthscale {ls}: max abs err {e}")
            err = max(err, e)
        iters = 200 if n * m <= 1 << 20 else 20
        call = lambda: gp_ops.matern52(x1, x2, 0.3)
        k_ms = cuda_ms(call, iters)
        dev_ms = device_ms_per_launch(call, "matern52_kernel")
        p_ms = cuda_ms(lambda: matern52_ref(x1, x2, 0.3),
                       max(iters // 4, 5))
        b_ms, b_by = gp_bound_ms(n, m, d)
        rows.append(dict(n=n, m=m, d=d, tag=tag, max_abs_err=err, ms=k_ms,
                         device_ms=dev_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by))
        dev = ("not measured" if dev_ms is None
               else f"{dev_ms * 1e3:.3f} us")
        print(f"gp_cov ({n}, {m}, {d}) {tag}: max abs err {err:.3g} over "
              f"lengthscales {GP_LENGTHSCALES}, wrapper {k_ms * 1e3:.2f} us "
              f"per call, device {dev} per launch, plain "
              f"{p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.4f} us ({b_by})")
        per_pair = 2 * d + GP_EPILOGUE_INSTRUCTIONS
        print(f"gp_cov ({n}, {m}, {d}) issue floor "
              f"{issue_floor_ms(n * m, per_pair, sm_clock_hz) * 1e3:.4f} us "
              f"({per_pair} instructions a pair at "
              f"{sm_clock_hz / 1e9:.3f} GHz)")
    return rows


def visible_pairs(Sq: int, Sk: int, mask: str, window: int, kvl) -> int:
    """(q, k) pairs the mask lets through, for one (b, h)."""
    valid = Sk if kvl is None else kvl
    p = torch.arange(Sq, dtype=torch.long) + (0 if kvl is None else kvl - Sq)
    hi = torch.clamp(torch.minimum(p + 1, torch.tensor(valid)), min=0) \
        if mask != "none" else torch.full_like(p, valid)
    lo = torch.clamp(p - window + 1, min=0) if mask == "window" \
        else torch.zeros_like(p)
    return int(torch.clamp(hi - lo, min=0).sum())


def fa_bound_ms(B, Sq, Sk, H, KV, D, Dv, mask, window, kvl,
                dtype) -> tuple:
    """Least time for one attention: q, k, v read once and out written
    once at the memory rate, or 2 (D + Dv) operations (the two products)
    per visible (q, k) pair and head at the peak rate of the input type
    (bf16 tensor cores, or FP32)."""
    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = size * (B * Sq * H * (D + Dv) + B * Sk * KV * (D + Dv)) \
        / PEAK_BYTES_PER_S * 1e3
    peak = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 \
        else PEAK_FP32_OPS_PER_S
    ops = 2 * B * H * (D + Dv) * visible_pairs(Sq, Sk, mask, window, kvl)
    t_ops = ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash_attention() -> list:
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape in FA_SHAPES:
        B, Sq, Sk, H, KV, D, Dv, mask, w, kvl, tag = shape
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, Sk, KV, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, Sk, KV, Dv, generator=gen,
                            device="cuda").to(dt)
            tc_before = fa_ops.flash_attention.launches_tc
            got = fa_ops.flash_attention(q, k, v, mask, w, kvl)
            torch.cuda.synchronize()
            tc = fa_ops.flash_attention.launches_tc - tc_before
            if tc != (dt == torch.bfloat16):
                fail(f"flash_attention at {shape[:-1]} {dt} moved the "
                     f"tensor-core count by {tc}")
            want = attention_ref(q, k, v, mask, w, kvl)
            serve = tag in FA_SERVE_TAGS
            tol = FA_TOL[dt]
            atol, rtol = (FA_BF16_SERVE_TOL if serve and dt == torch.bfloat16
                          else (tol, tol))
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if not bool((diff <= atol + rtol * want.float().abs()).all()):
                fail(f"flash_attention disagrees with its plain version at "
                     f"{shape[:-1]} {dt}: max abs err {err} (atol {atol}, "
                     f"rtol {rtol})")
            row = dict(shape=list(shape[:-1]), tag=tag, dtype=str(dt),
                       max_abs_err=err, tolerance=tol, atol=atol, rtol=rtol)
            if tag in FA_TIMED_TAGS:
                row.update(time_attention(q, k, v, mask, w, kvl))
            rows.append(row)
            timing = (f", kernel {row['ms'] * 1e3:.2f} us, plain "
                      f"{row['plain_ms'] * 1e3:.2f} us, sdpa "
                      f"{row['library_ms'] * 1e3:.2f} us, bound "
                      f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})"
                      if "ms" in row else "")
            print(f"flash_attention {shape[:-1]} {tag} {dt}: max abs err "
                  f"{err:.3g} (atol {atol}, rtol {rtol}){timing}")
    return rows


def time_attention(q, k, v, mask, w, kvl) -> dict:
    """Kernel, plain version and one ``scaled_dot_product_attention`` call
    (boolean mask, ``enable_gqa``; the port never calls it) on the same
    inputs, CUDA-event means."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    k_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, mask, w, kvl), 20)
    p_ms = cuda_ms(lambda: attention_ref(q, k, v, mask, w, kvl), 5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    valid = Sk if kvl is None else kvl
    qp = torch.arange(Sq, device="cuda")[:, None] + (valid - Sq
                                                     if kvl is not None
                                                     else 0)
    kp = torch.arange(Sk, device="cuda")[None, :]
    allowed = kp < valid
    if mask != "none":
        allowed = allowed & (kp <= qp)
    if mask == "window":
        allowed = allowed & (qp - kp < w)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allowed, enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - fa_ops.flash_attention(q, k, v, mask, w,
                                              kvl).float()).abs().max())
    l_ms = cuda_ms(sdpa, 20)
    b_ms, b_by = fa_bound_ms(B, Sq, Sk, H, KV, D, Dv, mask, w, kvl,
                             q.dtype)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, library_max_abs_diff=lib_err,
                pairs_per_head=visible_pairs(Sq, Sk, mask, w, kvl))


def ms_bound_ms(B, S, Di, Ds, with_h0: bool) -> tuple:
    """Least time for one scan: u, delta, A, Bc, Cc (and h0) read once and
    y, h_T written once at the memory rate, or 6 FP32 operations per
    (b, t, di, n) (delta A, its exponential, the update FMA, the output
    FMA) at the FP32 rate."""
    elems = (3 * B * S * Di + Di * Ds + 2 * B * S * Ds
             + B * Di * Ds * (2 if with_h0 else 1))
    t_bytes = 4 * elems / PEAK_BYTES_PER_S * 1e3
    t_ops = 6 * B * S * Di * Ds / PEAK_FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ms_sfu_floor_ms(B, S, Di, Ds, split: dict, sm_clock_hz: float) -> dict:
    """The scan's floor on the special-function units: one exponential per
    (b, t, di, n) at SFU_PER_SM per SM per clock over the whole card, and
    at the busiest SM sub-partition (a quarter of an SM, with a quarter of
    its SFUs) of this launch, which holds at most ceil(warps of the
    fullest SM / 4) warps of states_per_thread exponentials a step each,
    at 32 / (SFU_PER_SM / 4) clocks a warp exponential."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    card = B * S * Di * Ds / (SFU_PER_SM * n_sm * sm_clock_hz) * 1e3
    warps_per_block = split["threads_per_block"] // 32
    most_blocks = -(-split["blocks"] // n_sm)
    most_warps = -(-most_blocks * warps_per_block // 4)
    busiest = (most_warps * split["states_per_thread"] * S
               * 32 / (SFU_PER_SM // 4) / sm_clock_hz * 1e3)
    return dict(card_ms=card, busiest_subpartition_ms=busiest,
                sm_clock_hz=sm_clock_hz, sms=n_sm,
                blocks_per_sm_most=most_blocks,
                blocks_per_sm_mean=split["blocks"] / n_sm,
                warps_per_subpartition_most=most_warps,
                warps_per_subpartition_mean=split["blocks"]
                * warps_per_block / (4 * n_sm))


def check_mamba_scan(sm_clock_hz: float) -> list:
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = []
    for shape in MS_SHAPES:
        B, S, Di, Ds, tag = shape
        for with_h0 in (False, True):
            u, dl = r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di))
            A = -torch.exp(r(Di, Ds) * 0.3)
            if shape == MS_HYMBA_A:
                A = -torch.arange(1, Ds + 1, dtype=torch.float32,
                                  device="cuda").expand(Di, Ds).contiguous()
            Bc, Cc = r(B, S, Ds), r(B, S, Ds)
            h0 = r(B, Di, Ds) if with_h0 else None
            y, hT = ms_ops.selective_scan(u, dl, A, Bc, Cc, h0)
            torch.cuda.synchronize()
            yr, hr = selective_scan_ref(u, dl, A, Bc, Cc, h0)
            err = 0.0
            for got, want in ((y, yr), (hT, hr)):
                diff = (got - want).abs()
                err = max(err, float(diff.max()))
                if not bool((diff <= MS_TOL + MS_TOL * want.abs()).all()):
                    fail(f"mamba_scan disagrees with its plain version at "
                         f"{shape[:-1]} {tag}, h0 {with_h0}: max abs err "
                         f"{err}")
            y2, hT2 = ms_ops.selective_scan(u, dl, A, Bc, Cc, h0)
            if not (torch.equal(y, y2) and torch.equal(hT, hT2)):
                fail(f"mamba_scan is not deterministic at {shape[:-1]} {tag}"
                     f", h0 {with_h0}: two calls differ")
            row = dict(shape=[B, S, Di, Ds], tag=tag, h0=with_h0,
                       max_abs_err=err, tolerance=MS_TOL)
            if shape in (MS_PREFILL, MS_DECODE) and with_h0 == (S == 1):
                k_ms = cuda_ms(lambda: ms_ops.selective_scan(u, dl, A, Bc,
                                                             Cc, h0), 50)
                p_ms = cuda_ms(lambda: selective_scan_ref(u, dl, A, Bc, Cc,
                                                          h0),
                               3 if S > 1 else 50)
                b_ms, b_by = ms_bound_ms(B, S, Di, Ds, with_h0)
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
            rows.append(row)
            timing = (f", kernel {row['ms'] * 1e3:.2f} us, plain "
                      f"{row['plain_ms'] * 1e3:.2f} us, bound "
                      f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})"
                      if "ms" in row else "")
            print(f"mamba_scan {shape[:-1]} {tag} h0={with_h0}: max abs err "
                  f"{err:.3g} (tol {MS_TOL}), deterministic{timing}")
            if "ms" in row:
                # the split and the SFU floor are computed from the shape
                # and the card's max SM clock, not measured: printed beside
                # the bound, not written to the kernels record
                split = ms_ops.split(B, Di, Ds)
                sfu = ms_sfu_floor_ms(B, S, Di, Ds, split, sm_clock_hz)
                print(f"mamba_scan {shape[:-1]} SFU floor "
                      f"{sfu['card_ms'] * 1e3:.3f} us (card) / "
                      f"{sfu['busiest_subpartition_ms'] * 1e3:.3f} us "
                      f"(busiest sub-partition) at max SM clock "
                      f"{sm_clock_hz / 1e9:.3f} GHz; split "
                      f"{json.dumps(split | sfu)}")
    # state threading: [0:S] in one call equals [0:S/2] then [S/2:S] from
    # the carried state (the decode-step invariant)
    B, S, Di, Ds = 2, 96, 200, 16
    u, dl = r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di))
    A, Bc, Cc = -torch.exp(r(Di, Ds) * 0.3), r(B, S, Ds), r(B, S, Ds)
    y, h = ms_ops.selective_scan(u, dl, A, Bc, Cc)
    half = lambda t, sl: t[:, sl].contiguous()
    y1, h1 = ms_ops.selective_scan(half(u, slice(0, S // 2)),
                                   half(dl, slice(0, S // 2)), A,
                                   half(Bc, slice(0, S // 2)),
                                   half(Cc, slice(0, S // 2)))
    y2, h2 = ms_ops.selective_scan(half(u, slice(S // 2, S)),
                                   half(dl, slice(S // 2, S)), A,
                                   half(Bc, slice(S // 2, S)),
                                   half(Cc, slice(S // 2, S)), h0=h1)
    err = max(float((torch.cat([y1, y2], 1) - y).abs().max()),
              float((h2 - h).abs().max()))
    if not err <= MS_TOL:
        fail(f"mamba_scan does not thread its state: max abs err {err}")
    print(f"mamba_scan state threading ({B}, {S}, {Di}, {Ds}): two calls "
          f"with the carried state equal one call within {err:.3g}")
    return rows


def hymba_card_vs_cpu() -> dict:
    """Phase 10: the serving slice on the card (kernels) against the CPU
    (plain versions), full width, 2 layers, float32, one weight set."""
    cfg = dataclasses.replace(get_config(HYMBA), n_layers=2, dtype="float32")
    card, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = card.init(0)
    params_cpu = HybridLM(cfg, "cpu")
    params_cpu.load_state_dict(params.state_dict())
    prompt = torch.randint(0, cfg.vocab, (1, 1024),
                           generator=torch.Generator().manual_seed(10))
    errs = {}

    def compare(name, a, b):
        e = float((a.float().cpu() - b.float()).abs().max())
        errs[name] = max(errs.get(name, 0.0), e)
        if not e <= LM_PARITY_TOL:
            fail(f"hymba card vs CPU: {name} max abs err {e} > "
                 f"{LM_PARITY_TOL}")

    t0 = time.perf_counter()
    fa_ops.flash_attention.launches = fa_ops.flash_attention.launches_tc = 0
    compare("forward logits", card.forward(params, {"tokens": prompt}),
            cpu.forward(params_cpu, {"tokens": prompt}))
    n_new = 4
    max_seq = prompt.shape[1] + cfg.meta_tokens + n_new + 1
    lg, cache = card.prefill(params, {"tokens": prompt},
                             card.init_cache(1, max_seq))
    lg_c, cache_c = cpu.prefill(params_cpu, {"tokens": prompt},
                                cpu.init_cache(1, max_seq))
    compare("prefill logits", lg, lg_c)
    base = prompt.shape[1] + cfg.meta_tokens
    for i in range(n_new):
        tok = torch.argmax(lg_c[:, -1], -1)[:, None]
        lg, cache = card.decode_step(params, tok, cache, base + i)
        lg_c, cache_c = cpu.decode_step(params_cpu, tok, cache_c, base + i)
        compare("decode logits", lg, lg_c)
        for j, (a, b) in enumerate(zip(_leaves(cache), _leaves(cache_c))):
            compare(f"cache leaf {j}", a, b)
    wall = time.perf_counter() - t0
    launches = dict(flash_attention=fa_ops.flash_attention.launches,
                    tensor_core=fa_ops.flash_attention.launches_tc)
    want = dict(flash_attention=2 * cfg.n_layers, tensor_core=0)
    if launches != want:
        fail(f"hymba card vs CPU launched {launches}, expected {want} (the "
             f"float32 SIMT kernel in the forward and the prefill)")
    print(f"hymba card vs CPU (d {cfg.d_model}, {cfg.n_layers} layers, "
          f"float32, prompt {prompt.shape[1]} + {cfg.meta_tokens} meta, "
          f"window {cfg.window}, {n_new} decode "
          f"steps): max abs err {json.dumps(errs)} (gate {LM_PARITY_TOL}); "
          f"{wall:.1f} s; attention launches {launches}")
    return dict(max_abs_err=errs, gate=LM_PARITY_TOL, wall_s=wall,
                launches=launches)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def hymba_serve() -> dict:
    """Phase 11: hymba-1.5b as configured, batch 4, a 1024-token prompt,
    32 generated tokens, through ``generate``."""
    cfg = get_config(HYMBA)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(11))
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = fa_ops.flash_attention.launches_tc = 0
    ms_ops.selective_scan.launches = 0
    first = generate(model, params, prompt, SERVE_TOKENS)
    launches = dict(flash_attention=fa_ops.flash_attention.launches,
                    flash_attention_tc=fa_ops.flash_attention.launches_tc,
                    mamba_scan=ms_ops.selective_scan.launches)
    peak = torch.cuda.max_memory_allocated()
    want = dict(flash_attention=cfg.n_layers,
                flash_attention_tc=cfg.n_layers,
                mamba_scan=cfg.n_layers * SERVE_TOKENS)
    if launches != want:
        fail(f"hymba serve launched {launches}, expected {want}")
    if not bool(torch.isfinite(first.logits).all()):
        fail("hymba serve: non-finite logits")
    again = generate(model, params, prompt, SERVE_TOKENS)
    if not torch.equal(first.tokens, again.tokens):
        fail("hymba serve: two runs gave different tokens")
    steps = SERVE_TOKENS - 1
    out = dict(params=sum(p.numel() for p in params.parameters()),
               init_s=init_s, launches=launches, peak_bytes=peak,
               runs=[dict(prefill_s=g.prefill_s, decode_s=g.decode_s,
                          decode_ms_per_token=g.decode_s / steps * 1e3,
                          tokens_per_s=SERVE_BATCH * SERVE_TOKENS
                          / (g.prefill_s + g.decode_s))
                     for g in (first, again)])
    for i, run in enumerate(out["runs"]):
        print(f"hymba serve run {i + 1} ({cfg.n_layers} layers, batch "
              f"{SERVE_BATCH}, prompt {SERVE_PROMPT} + {cfg.meta_tokens} "
              f"meta, {SERVE_TOKENS} tokens): prefill {run['prefill_s']:.4f}"
              f" s, decode {run['decode_ms_per_token']:.3f} ms/token, "
              f"{run['tokens_per_s']:.1f} tokens/s")
    print(f"hymba serve: {out['params']} parameters, init {init_s:.2f} s, "
          f"launches {launches}, peak device memory {peak / 2**30:.3f} GiB, "
          f"first sequence {first.tokens[0].tolist()}")

    # one decode step alone: wall (synchronized) and, under the profiler,
    # device time and kernel count
    B = SERVE_BATCH
    base = SERVE_PROMPT + cfg.meta_tokens
    _, cache = model.prefill(params, {"tokens": prompt}, model.init_cache(
        B, base + SERVE_TOKENS + 1))
    tok = first.tokens[:, :1]
    model.decode_step(params, tok, cache, base)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.decode_step(params, tok, cache, base)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    device_s, n_kernels, by_name = device_by_kernel(
        lambda: model.decode_step(params, tok, cache, base))
    out.update(decode_step_s=step_s)
    pre_cache = model.init_cache(B, base + SERVE_TOKENS + 1)
    pre_s, pre_n, pre_by = device_by_kernel(
        lambda: model.prefill(params, {"tokens": prompt}, pre_cache))
    if device_s <= 0 or pre_s <= 0:
        print("hymba decode step: device busy share not measured (the "
              "profiler saw no device events)")
        return out
    out.update(decode_step_device_s=device_s,
               decode_step_busy_share=device_s / step_s,
               decode_step_kernels=n_kernels,
               decode_step_split=kernel_split(by_name, device_s),
               prefill_device_s=pre_s, prefill_kernels=pre_n,
               prefill_busy_share=pre_s / again.prefill_s,
               prefill_split=kernel_split(pre_by, pre_s))
    print(f"hymba decode step: {step_s * 1e3:.3f} ms wall; under the "
          f"profiler {device_s * 1e3:.3f} ms device time = "
          f"{device_s / step_s:.1%} of that wall, {n_kernels} kernels; "
          f"split {json.dumps(out['decode_step_split'])}")
    print(f"hymba prefill: under the profiler {pre_s * 1e3:.3f} ms device "
          f"time = {out['prefill_busy_share']:.1%} of run 2's prefill wall,"
          f" {pre_n} kernels; split {json.dumps(out['prefill_split'])}")
    scan_dec = out["decode_step_split"]["mamba_scan"]
    scan_pre = out["prefill_split"]["mamba_scan"]
    if scan_dec["count"] != cfg.n_layers or scan_pre["count"] != cfg.n_layers:
        fail(f"the profiler saw {scan_dec['count']} scan kernels in a decode "
             f"step and {scan_pre['count']} in prefill, expected "
             f"{cfg.n_layers} each")
    out.update(scan_decode_device_ms=scan_dec["s"] / scan_dec["count"] * 1e3,
               scan_prefill_device_ms=scan_pre["s"] * 1e3)
    print(f"hymba scan: {out['scan_decode_device_ms'] * 1e3:.3f} us of "
          f"device time per decode launch ({scan_dec['count']} in a step), "
          f"{out['scan_prefill_device_ms']:.3f} ms in prefill "
          f"({scan_pre['count']} launches, {scan_pre['share']:.1%} of its "
          f"device time)")
    attn = out["prefill_split"]["flash_attention_tc"]
    print(f"hymba prefill attention: {attn['count']} tensor-core launches, "
          f"{attn['s'] * 1e3:.3f} ms = {attn['share']:.1%} of prefill device "
          f"time")
    return out


def ptxas_report(lib: Path, kernel_re: str) -> dict:
    """Registers, static shared memory and spills of each kernel whose
    mangled name ``kernel_re`` matches (group 1 the name, the others its
    template arguments), from the ``-Xptxas -v`` log kept beside the
    library."""
    log = lib.with_suffix(".log").read_text()
    kernels = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = re.search(kernel_re, chunk)
        if name is None:
            continue
        num = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        kernels[f"{name[1]}<{','.join(name.groups()[1:])}>"] = dict(
            registers=num(r"Used (\d+) registers"),
            static_smem_bytes=num(r"(\d+) bytes smem"),
            spill_stores=num(r"(\d+) bytes spill stores"),
            spill_loads=num(r"(\d+) bytes spill loads"))
    return kernels


def attention_build_report(lib: Path) -> dict:
    """The attention kernels' ``ptxas_report`` and the count of ``HGMMA``
    (wgmma) instructions in the library's SASS where ``cuobjdump`` is
    installed; fails if the tensor-core kernel has none."""
    kernels = ptxas_report(lib,
                           r"(attn_fwd(?:_wgmma)?_kernel)ILi(\d+)ELi(\d+)E")
    out = dict(kernels=kernels, hgmma="not checked (no cuobjdump)")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).is_file():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        out["hgmma"] = sass.count("HGMMA")
        if out["hgmma"] == 0:
            fail("the flash_attention library holds no HGMMA instruction")
    for name in ("attn_fwd_kernel<192,128>", "attn_fwd_wgmma_kernel<192,128>"):
        if name not in kernels:
            fail(f"the flash_attention build log names no {name} (MLA's "
                 f"head dims)")
    print(f"flash_attention build: {json.dumps(kernels)}; HGMMA "
          f"instructions in the SASS: {out['hgmma']}")
    return out


def small_build_report(libs: dict) -> dict:
    """The ``ptxas_report`` of the pareto_rank and gp_cov kernels (one
    instantiation per objective count, and per gp_cov tile shape)."""
    out = dict(pareto_rank=ptxas_report(libs["pareto_rank"],
                                        r"(rank_kernel)ILi(\d+)E"),
               gp_cov=ptxas_report(
                   libs["gp_cov"],
                   r"(matern52_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi"
                   r"(\d+)E"))
    print(f"pareto_rank and gp_cov build: {json.dumps(out)}")
    return out


def scan_build_report(lib: Path) -> dict:
    """The scan kernels' ``ptxas_report`` (one instantiation per state-size
    class: states a thread, threads a channel, steps ahead); fails if one
    spills."""
    kernels = ptxas_report(lib, r"(scan_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E")
    if not kernels:
        fail("the mamba_scan build log names no scan_kernel")
    spills = {k: v for k, v in kernels.items()
              if v["spill_stores"] or v["spill_loads"]}
    if spills:
        fail(f"mamba_scan kernels spill registers: {json.dumps(spills)}")
    print(f"mamba_scan build: {json.dumps(kernels)}")
    return kernels


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


def device_by_kernel(fn) -> tuple:
    """(device seconds, kernel count, {kernel name: (device seconds,
    count)}) of one synchronized call of ``fn`` under ``torch.profiler``;
    (0, 0, {}) when it sees no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in dev) * 1e-6,
            sum(e.count for e in dev),
            {e.key: (e.self_device_time_total * 1e-6, e.count) for e in dev})


def kernel_split(by_name: dict, total_s: float, top: int = 5) -> dict:
    """Device seconds of the port's LM kernels (the two attention kernels
    by their own names, the scan) and of the ``top`` kernels by device
    time, each with its share of ``total_s``."""
    def share(keys):
        t = sum(by_name[k][0] for k in keys)
        return dict(s=t, share=t / total_s if total_s > 0 else 0.0,
                    count=sum(by_name[k][1] for k in keys))
    out = {name: share([k for k in by_name if tag in k])
           for name, tag in (("flash_attention_tc", "attn_fwd_wgmma_kernel"),
                             ("flash_attention_simt", "attn_fwd_kernel"),
                             ("mamba_scan", "scan_kernel"))}
    out["top"] = [dict(kernel=k[:120], s=t, count=c,
                       share=t / total_s if total_s > 0 else 0.0)
                  for k, (t, c) in sorted(by_name.items(),
                                          key=lambda kv: -kv[1][0])[:top]]
    return out


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
    device_s, n_kernels = device_by_kernel(lambda: run(3, pop0))[:2]
    eval_device_s, eval_kernels = device_by_kernel(lambda: evaluate(pop0))[:2]
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


def quickstart_problem():
    return Problem(presets.transformer_block(seq=512, d=512, heads=2),
                   ("latency_ns", "energy_pj"), ch_max=6,
                   space_kwargs=dict(max_total_pes=4096))


def check_best(problem, r) -> float:
    """The best design re-evaluates to its metrics and to its objective
    (EDP weights plus 8 log penalty, rtol 1e-5); the trace is finite,
    non-increasing and ends at that objective.  Returns the design's
    feasibility penalty.  The penalty is reported, not required to be 1:
    the reference's own quickstart query returns designs over the node
    limit at seeds 0-2 (penalties 140.3, 16.7 and 5 at 250 SA steps on
    the CPU, ``tests/test_torch_optimizer.py``, which also holds the
    port's mean log penalty to the reference's), so feasibility is not a
    property of this query."""
    d = {k: torch.as_tensor(v, device="cuda")[None]
         for k, v in r.best_design.items()}
    m = evaluate_system(problem.spec, d)
    again = metric_stack(m)[0].double().cpu().numpy()
    want = np.asarray([float(r.best_metrics[k]) for k in METRIC_KEYS])
    np.testing.assert_allclose(again, want, rtol=1e-5,
                               err_msg="best metrics do not re-evaluate")
    obj = float(objective_from_metrics(problem.space, d, m, OBJ_EDP)[0])
    np.testing.assert_allclose(obj, r.best_objective, rtol=1e-5,
                               err_msg="best objective does not re-evaluate")
    best = r.trace.best
    if not (np.all(np.isfinite(best)) and np.all(np.diff(best) <= 0)
            and abs(best[-1] - r.best_objective) <= 1e-6 * abs(best[-1])):
        fail(f"trace.best is not finite, non-increasing and ending at the "
             f"best objective: {best}")
    pen = float(feasibility_penalty(problem.space, d, m)[0])
    if not (np.isfinite(pen) and pen >= 1.0):
        fail(f"bad feasibility penalty {pen}")
    return pen


def counted_submit(query):
    """``Session.submit`` on the card with every kernel's launch count set
    to 0 just before and read just after: (result, wall seconds, counts)."""
    with tempfile.TemporaryDirectory() as cache:
        session = Session(cache_dir=cache, device="cuda")
        gp_ops.matern52.launches = 0
        pareto_ops.dominance_counts.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = session.submit(query)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return r, wall, dict(gp_cov=gp_ops.matern52.launches,
                         pareto_rank=pareto_ops.dominance_counts.launches)


def quickstart() -> dict:
    """Phase 8: the README's quickstart query through Session.submit."""
    problem = quickstart_problem()
    r, wall, launches = counted_submit(Query(
        problem, engine="bo_sa", weights=OBJ_EDP,
        engine_opts=dict(QUICK_OPTS, sa=QUICK_SA)))
    rounds = QUICK_OPTS["n_init"] + QUICK_OPTS["n_iter"]
    want_evals = rounds * QUICK_SA.steps * QUICK_SA.chains
    if r.provenance.n_evals_run != want_evals:
        fail(f"quickstart ran {r.provenance.n_evals_run} evaluations, "
             f"expected {want_evals}")
    if launches["gp_cov"] != 2 * QUICK_OPTS["n_iter"]:
        fail(f"gp_cov launched {launches['gp_cov']} times for "
             f"{QUICK_OPTS['n_iter']} BO iterations")
    pen = check_best(problem, r)
    out = dict(wall_s=wall, evals=want_evals, evals_per_s=want_evals / wall,
               sa_runs=rounds, sa_steps=rounds * QUICK_SA.steps,
               best_objective=r.best_objective, best_penalty=pen,
               launches=launches,
               best_metrics={k: float(r.best_metrics[k])
                             for k in METRIC_KEYS})
    print(f"quickstart bo_sa: {want_evals} evaluations in {wall:.3f} s "
          f"({want_evals / wall:.1f} evaluations/s), {rounds} SA runs x "
          f"{QUICK_SA.steps} steps x {QUICK_SA.chains} chains, best "
          f"objective {r.best_objective:.6f} (EDP nats, feasibility "
          f"penalty {pen:.6g}), trace "
          f"{np.round(r.trace.best, 4).tolist()}, gp_cov launches "
          f"{launches['gp_cov']}, pareto_rank launches "
          f"{launches['pareto_rank']}")
    out.update(split_quickstart(problem, r))
    return out


def split_quickstart(problem, r) -> dict:
    """One SA step and one BO acquisition of the quickstart, timed on
    their own (host clock around synchronized work), and the device busy
    share of a short SA run from torch.profiler."""
    steps = 50
    sa_run = make_sa(problem.spec, problem.space,
                     sa=SAConfig(steps=steps, chains=QUICK_SA.chains),
                     device="cuda")
    d0 = {k: torch.as_tensor(v, device="cuda")
          for k, v in r.best_design.items()}
    sa_run(1, d0, OBJ_EDP)                         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ob = sa_run(2, d0, OBJ_EDP)
    float(ob)
    sa_step_ms = (time.perf_counter() - t0) / steps * 1e3

    rng = np.random.default_rng(0)
    n_obs = QUICK_OPTS["n_init"] + QUICK_OPTS["n_iter"] - 1
    X = torch.as_tensor(rng.random((n_obs, 62)), dtype=torch.float32,
                        device="cuda")
    y = torch.as_tensor(30 + rng.standard_normal(n_obs),
                        dtype=torch.float32, device="cuda")
    Z = torch.as_tensor(rng.random((512, 62)), dtype=torch.float32,
                        device="cuda")

    def acquire():
        mu, sg = gp_posterior(X, y, Z)
        return int(torch.argmax(prob_improvement(mu, sg, 29.0)))
    for _ in range(3):
        acquire()
    t0 = time.perf_counter()
    for _ in range(20):
        acquire()
    acq_ms = (time.perf_counter() - t0) / 20 * 1e3
    out = dict(sa_step_ms=sa_step_ms, acquisition_ms=acq_ms)
    print(f"quickstart split: one SA step (4 chains) {sa_step_ms:.2f} ms; "
          f"one BO acquisition (GP over {n_obs} points, 512 candidates, "
          f"d = 62) {acq_ms:.2f} ms")

    prof_steps = 20
    short = make_sa(problem.spec, problem.space,
                    sa=SAConfig(steps=prof_steps, chains=QUICK_SA.chains),
                    device="cuda")
    short(3, d0, OBJ_EDP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short(4, d0, OBJ_EDP)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # the same run again under the profiler: its device time over the
    # unprofiled wall (the profiler's own host cost would inflate the wall)
    device_s, n_kernels = device_by_kernel(lambda: short(4, d0, OBJ_EDP))[:2]
    if device_s <= 0:
        print("quickstart split: device busy share not measured (the "
              "profiler saw no device events)")
        return out
    out.update(profiled_sa_steps=prof_steps, profiled_run_s=run_s,
               device_s=device_s, device_busy_share=device_s / run_s,
               kernels_per_sa_step=n_kernels / prof_steps)
    print(f"quickstart split: one {prof_steps}-step SA run: "
          f"{run_s * 1e3:.1f} ms wall; under the profiler device busy "
          f"{device_s * 1e3:.2f} ms = {out['device_busy_share']:.1%} of that"
          f" wall, {out['kernels_per_sa_step']:.0f} kernels per SA step")
    return out


def two_stage() -> dict:
    """Phase 9: two_stage on the quickstart problem with an archive."""
    problem = quickstart_problem()
    arc = ParetoArchive(256, random_design(0, problem.space, device="cuda"),
                        obj_keys=METRIC_KEYS, device="cuda")
    r, wall, launches = counted_submit(Query(
        problem, engine="two_stage", archive=arc,
        engine_opts=dict(sa=TWO_STAGE_SA)))
    kept = r.raw.history[-1][1]
    # stage 1: 3 scalarizations x 6 BO iterations; stage 2: 4 per kept
    want_gp = 2 * (3 * 6 + 4 * kept)
    if launches["gp_cov"] != want_gp:
        fail(f"two_stage launched gp_cov {launches['gp_cov']} times, "
             f"expected {want_gp} ({kept} candidates kept)")
    if launches["pareto_rank"] < 3 + kept:
        fail(f"two_stage launched pareto_rank {launches['pareto_rank']} "
             f"times for {3 + kept} archive inserts")
    pen = check_best(problem, r)
    # the archive keeps only feasible SA-refined designs; without one the
    # front is the single incumbent (the API's contract)
    designs, metrics = arc.front()
    idx = [METRIC_KEYS.index(o) for o in problem.objectives]
    keep = pareto_front(metrics[:, idx]) if len(metrics) else []
    want = metrics[keep] if len(keep) else np.asarray(
        [[float(r.best_metrics[k]) for k in METRIC_KEYS]])
    if not np.array_equal(r.front_metrics, want):
        fail("the two_stage front is not the archive's projected front")
    d = {k: torch.as_tensor(np.stack([x[k] for x in r.front_designs]),
                            device="cuda") for k in r.front_designs[0]}
    m = evaluate_system(problem.spec, d)
    np.testing.assert_allclose(metric_stack(m).double().cpu().numpy(),
                               r.front_metrics, rtol=1e-5,
                               err_msg="front metrics do not re-evaluate")
    if len(keep) and float(feasibility_penalty(problem.space, d,
                                               m).max()) > 1.0 + 1e-6:
        fail("the archive's front holds an infeasible design")
    out = dict(wall_s=wall, evals_reported=r.provenance.n_evals_run,
               kept=kept, archive_rows=len(arc), front=len(r.front_metrics),
               best_objective=r.best_objective, best_penalty=pen,
               launches=launches)
    print(f"two_stage: {wall:.3f} s, {kept} architecture candidates kept, "
          f"archive {len(arc)} rows, front {len(r.front_metrics)} points, "
          f"best objective {r.best_objective:.6f} (penalty {pen:.6g}), "
          f"gp_cov launches "
          f"{launches['gp_cov']} (d = 60 and 2), pareto_rank launches "
          f"{launches['pareto_rank']}")
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
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}; max SM clock "
          f"{sm_clock_hz / 1e6:.0f} MHz")

    # ---- 2. build every kernel, one nvcc each, all started together -------
    t0 = time.perf_counter()
    builds = {"pareto_rank": pareto_ops.build, "gp_cov": gp_ops.build,
              "flash_attention": fa_ops.build, "mamba_scan": ms_ops.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = {name: f.result() for name, f in
                [(n, pool.submit(b)) for n, b in builds.items()]}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    fa_build = attention_build_report(libs["flash_attention"])
    ms_build = scan_build_report(libs["mamba_scan"])
    small_build = small_build_report(libs)

    # ---- 3. kernels against their plain versions ---------------------------
    pareto_rows = check_pareto_rank(sm_clock_hz)
    gp_rows = check_gp_cov(sm_clock_hz)
    fa_rows = check_flash_attention()
    ms_rows = check_mamba_scan(sm_clock_hz)

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

    # ---- 8. the quickstart query: BO x SA with gp_cov ----------------------
    quick = quickstart()

    # ---- 9. two_stage with an archive --------------------------------------
    staged = two_stage()

    # ---- 10. the LM serving slice: card against CPU -----------------------
    lm_parity = hymba_card_vs_cpu()

    # ---- 11. the LM serving slice at full size -----------------------------
    served = hymba_serve()

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
        device_ms_per_launch=main_row["device_ms"],
        build=small_build["pareto_rank"],
        kernel_us=main_row["ms"] * 1e3, plain_us=main_row["plain_ms"] * 1e3,
        bound_us=main_row["bound_ms"] * 1e3, shapes=pareto_rows,
        main_path=dict(cold_s=cold_s, warm_s=warm_s,
                       evals=pv.n_evals_run,
                       evals_per_s=pv.n_evals_run / cold_s,
                       generations=gens, segments=segs,
                       front_size=int(len(cold.front_objs)), hv=hv,
                       breakdown=split))
    gp_main = next(r for r in gp_rows if r["tag"] == "quickstart K(Z, X)")
    gp_record = dict(
        name="gp_cov", route="cuda",
        source="src/repro_torch/kernels/gp_cov/csrc/gp_cov.cu",
        replaces="src/repro/kernels/gp_cov/gp_cov.py:36",
        launches=quick["launches"]["gp_cov"],
        max_abs_err=max(r["max_abs_err"] for r in gp_rows),
        ms=gp_main["ms"], plain_ms=gp_main["plain_ms"],
        bound_ms=gp_main["bound_ms"], bound_by=gp_main["bound_by"],
        library_ms=None, tolerance=GP_TOL,
        device_ms_per_launch=gp_main["device_ms"],
        build=small_build["gp_cov"], shapes=gp_rows,
        main_path=dict(quickstart=quick, two_stage=staged))
    def fa_rows_of(dt):
        return [r for r in fa_rows if r["dtype"] == str(dt)]
    bf16_rows, f32_rows = fa_rows_of(torch.bfloat16), fa_rows_of(torch.float32)
    fa_main = next(r for r in bf16_rows if r["tag"] == "hymba prefill")
    fa_record = dict(
        name="flash_attention", route="cuda",
        source=FA_SOURCES + "flash_attention_wgmma.cu", replaces=FA_REPLACES,
        dtype="bfloat16",
        launches=served["launches"]["flash_attention_tc"],
        max_abs_err=max(r["max_abs_err"] for r in bf16_rows),
        ms=fa_main["ms"], plain_ms=fa_main["plain_ms"],
        bound_ms=fa_main["bound_ms"], bound_by=fa_main["bound_by"],
        library_ms=fa_main["library_ms"],
        tolerance=FA_TOL[torch.bfloat16], serve_tolerance=FA_BF16_SERVE_TOL,
        build=fa_build, shapes=bf16_rows, main_path=dict(serve=served))
    f32_main = next(r for r in f32_rows if r["tag"] == "hymba prefill")
    fa_f32_record = dict(
        name="flash_attention_f32", route="cuda",
        source=FA_SOURCES + "flash_attention.cu", replaces=FA_REPLACES,
        dtype="float32", launches=lm_parity["launches"]["flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in f32_rows),
        ms=f32_main["ms"], plain_ms=f32_main["plain_ms"],
        bound_ms=f32_main["bound_ms"], bound_by=f32_main["bound_by"],
        library_ms=f32_main["library_ms"], tolerance=FA_TOL[torch.float32],
        shapes=f32_rows, main_path=dict(card_vs_cpu=lm_parity))
    ms_main = next(r for r in ms_rows if r["tag"] == "hymba prefill"
                   and "ms" in r)
    ms_dec = next(r for r in ms_rows if r["tag"] == "hymba decode"
                  and "ms" in r)
    ms_record = dict(
        name="mamba_scan", route="cuda",
        source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan/mamba_scan.py:63",
        launches=served["launches"]["mamba_scan"],
        max_abs_err=max(r["max_abs_err"] for r in ms_rows),
        ms=ms_main["ms"], plain_ms=ms_main["plain_ms"],
        bound_ms=ms_main["bound_ms"], bound_by=ms_main["bound_by"],
        library_ms=None, tolerance=MS_TOL, decode_ms=ms_dec["ms"],
        decode_plain_ms=ms_dec["plain_ms"], decode_bound_ms=ms_dec["bound_ms"],
        decode_device_ms_per_launch=served.get("scan_decode_device_ms"),
        prefill_device_ms=served.get("scan_prefill_device_ms"),
        build=ms_build, shapes=ms_rows)
    print(json.dumps({"kernels": [record, gp_record, fa_record,
                                  fa_f32_record, ms_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
