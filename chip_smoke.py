"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; none is skipped):

1. the card: ``torch.cuda.get_device_name(0)`` and the name and power limit
   as ``nvidia-smi`` reports them;
2. build every kernel of the driven paths from its sources (``pareto_rank``
   with its lane axis,
   ``gp_cov``, ``flash_attention`` — its float32 kernels (3xTF32 on the
   tensor cores: a tile kernel and a key-split kernel), its bfloat16
   tensor-core kernel and its backward kernels in one library —
   and ``mamba_scan`` with its backward), one ``nvcc`` a source, all
   started together; print the build seconds, the
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
   held to about one bf16 rounding, atol 4e-3 and rtol 8e-3, every call of
   either dtype counted as one tensor-core launch and two calls bitwise
   equal, after a probe of the float32 kernels' 3xTF32 products against
   float64; 1e-4 for the scan, also with Hymba's A = -(1..16) and at ragged
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
   and ``SAConfig(steps=50, chains=4)`` (the README's 250 SA steps cut to
   50, a cut of depth only) — 12 SA runs, 2 ``gp_cov``
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
    float32 3xTF32 kernel: one tensor-core launch per layer in the forward
    and in the prefill);
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
    device time per decode launch and in prefill;
12. transfer, fleet cache and resume on the card, through
    ``Session.submit`` / ``Session.plan``, every query timed with its
    evaluations/s and ``pareto_rank`` / ``gp_cov`` launches:
    (a) the reference's transfer benchmark (``benchmarks/bench_transfer.py``)
    at its full budget B = 4096 — pop 32, no immigrants, one mutation,
    non-adaptive budgets, the bounded space ``max_shape=(8, 8, 2, 2, 1,
    2)`` at ``ch_max=2``: the held-out ``attn_qwen2_5_32b`` cold at B
    (``balanced_init`` seed) against the same query at B/2 after the
    ``attn_qwen2_72b`` and ``attn_internlm2`` neighbors;
    (b) its warm-refinement arms: a B/8 shallow run, cloned, refined at B
    unseeded and seeded (4-generation segments, a manifest bounded at 2
    entries); both at the benchmark's key 42 and at 43-46, one process a
    key, the five started together.  Asserted at
    every key: the transfer arm spends <= 60% of the cold run's
    evaluations, both seeded runs take >= 1 neighbor, the manifest keeps
    <= 2 entries and ``nearest`` answers.  The benchmark's hypervolume
    conditions, on the runs pooled over the five keys: the transfer arms'
    mean hypervolume at least the cold arms', and the seeded refinements'
    mean trace crossing the unseeded ones' mean final hypervolume within
    75% of their evaluations; and each gate met alone at >= 2 of the five
    keys (each key's own verdict is printed);
    (c) phase 5's query stopped by a ``RunControl`` after its second
    segment and resumed in a fresh session: interrupted, the two spends sum
    to phase 5's, and the resumed front is phase 5's byte for byte (a third,
    uninterrupted run must agree too);
    (d) two processes write transfer queries on two library graphs into one
    cache directory at once: both manifest entries survive, both archives
    load, and a third process's ``Session.plan`` names the neighbors (each
    with a seed quota) its run then reports in ``transferred_from``;
    (e) a registered tech preset (``DEFAULT_TECH`` with ``router_delay_ns``
    10 in place of 20) lands under its own cache key with ``tech ==
    "<name>@<digest12>"``, and the quickstart ``bo_sa`` query, SA steps cut
    250 -> 10 as in phase 9, seeded with designs migrated out of (a)'s
    front, launches ``gp_cov`` 16 times and returns a feasible best design;
    the device busy share of the preset's query from ``torch.profiler``;
13. megabatched and surrogate-gated search on the card:
    (a) the batched ``pareto_rank`` (L lanes of one shape in one launch)
    against its plain version, exactly, at a fused run's pools — 8 lanes
    of NSGA selection at pop 64 (8, 128, 2) and of its telemetry (8, 64,
    2), (3, 768, 4), lanes with NaN and +-inf, and one lane (against the
    single-pool entry too) — timed beside L single-pool launches, L times
    one pool's bound and the plain version; ``make_nsga_fused`` over the
    reference's megabatch benchmark problems (``benchmarks/bench_scale.py``:
    the BERT attention blocks att1-att4, ``ch_max=2``), each lane's designs
    bit-identical to its unbatched run and its raw metrics within rtol
    1e-6; that benchmark's gate, distinct-problem throughput >= 0.8 x the
    same-problem fused batch at 8 lanes, with evaluations/s fused and
    sequential, kernels and ``pareto_rank`` launches a generation and the
    device busy share at L = 1, 4 and 8; one ``Session.submit`` of the
    four problems at the default query (budget 2048, pop 64) fused
    (``BudgetPolicy()``) against ``megabatch=False``: the same fronts
    (designs bit-identical, metrics rtol 1e-6, equal spend), with the
    counts set to 0 just before each and read just after;
    (b) the reference's surrogate benchmark (``benchmarks/
    bench_surrogate.py``) at its full budget: in phase 12's space, train on
    the ``attn_qwen2_72b`` and ``attn_internlm2`` blocks exactly at B, then
    search the held-out ``attn_qwen2_5_32b`` exact at B and gated at 2B
    (``exact_frac=0.25``, its own key excluded), at keys 100-115 dealt to
    8 worker processes started together; at every key the gate is used,
    never falls back, spends <= 50% of the exact arm's evaluations and
    evaluations + hits equal the 2B schedule; over the keys the mean gated
    hypervolume is >= 0.960 x the mean exact one (see ``SUR_POOLED_HV``);
    and gating asked for on an empty cache is the exact path bit for bit;
14. calibration and the flight recorder on the card (no kernel of their
    own; the recorder wraps the search path, which runs ``pareto_rank``):
    (a) the default calibration — the whole ``simulator_sweep()`` plus
    ``baseline_measurements()`` under ``DEFAULT_FREE``, 100 Adam steps
    (the default's 400, cut) —
    fit on the card and on the CPU (fitted values within rtol 1e-3), and
    two card fits of ``CALIB_REPEAT_STEPS`` steps with one artifact
    digest, with its wall seconds, ms a
    step, and launches and device busy share a step from ``torch.profiler``;
    (b) the reference's ``bench_validation`` calibration arm at its full
    budget: fit on its first six shapes x bandwidths (128, 16) GB/s, 400
    steps at lr 0.05, the last three shapes held out; the held-out mean
    latency error <= min(0.5 x uncalibrated, 9.8%), and the fitted
    ``t_tile_overhead_ns``;
    (c) the 4 x 25 jacobian of the metrics over the fittable fields on the
    golden design: finite, every ``METRIC_FIELDS`` entry non-zero,
    ``core_buf_bw`` non-zero with the buffers starved, and the CPU's
    within rtol 1e-4;
    (d) the reference's ``bench_obs`` gates on phase 5's query (budget
    2048, non-adaptive and without reallocation, as bench_obs runs it):
    the journaled submission costs at most max(3%, 50 ms) more than the
    disabled one (the trimmed mean of the pairs' differences, 16 to 40
    pairs, ending once that mean plus two standard errors is below the
    gate; each pair's
    arms taking turns at segment boundaries, in a fresh process, fresh
    archives; medians and minima printed), identical
    fronts, the journal replaying to the in-memory result, and the report
    showing every planned segment; then a cold ``Plan.predicted_s`` (not
    ``None``) beside the wall it predicted;
    (e) (b)'s fit saved as a ``CalibratedTech`` into a temporary
    ``$REPRO_CALIB_DIR``, resolved by name, serving one NSGA query with
    ``Session(tech=<name>)`` whose ``Provenance.tech`` names the preset;
15. the async serving shell on the card (``repro_torch.serve``; the search
    path, so ``pareto_rank``, launched from several host threads at once):
    (a) the reference's serving benchmark (``benchmarks/bench_serve.py``)
    at its full settings — budget 256, 16 fleet clients, 4 overload
    clients, a 900 s deadline, one matmul 512 x 512 x k at ``ch_max=2``,
    pop 8 — with its gates: every fleet client served (p50 / p99 time to
    front and the hit rate printed), every overload client served its
    cached front stale with 0 evaluations within the deadline and the
    banked jobs drained to DONE, an interrupted and resumed run
    bit-identical to the uninterrupted one with exact residual spend (its
    wall overhead printed);
    (b) 8 clients of phase 5's query (budget 2048, pop 64) in bench_serve's
    warm / refine / cold mix, each on a transformer block of its own,
    through one ``Executor`` with 2 worker threads, with the count set to 0
    just before and read just after, then the same jobs one after another
    in a fresh session with the same keys: every client served, each job's
    front and spend equal to its sequential run's, the ``pareto_rank``
    launch totals equal; p50 / p99, and the device busy share of both from
    ``torch.profiler``;
    (c) a ``Session.submit_async`` job bit-identical to ``Session.submit``
    of its query and seed while a second job's segments interleave with
    its own in the other worker thread;
    (d) the SIGKILL drill: ``python -m repro_torch.serve.worker --once
    --segment-delay 1.0`` killed after its first checkpointed segment; a
    second worker prints ``RECOVERED``, ends DONE after 2 attempts,
    spends only the residual budget, and its archive's valid rows are
    byte-identical to an uninterrupted card run's;
    (e) a RUNNING job cancelled keeps its checkpoint; the query recorded
    again is finished by a fresh executor's ``resume_pending`` to the
    uninterrupted front, the two spends summing to its spend;
16. every LM family on the card (phase 3 holds their attention and scan
    shapes: internlm2's prefill into a 1057-position cache and its decode
    step, MLA decode at DeepSeek-V2's width, whisper's cross-attention
    over 1500 frames, the Falcon-Mamba scan in prefill and decode):
    (a) ``internlm2-1.8b`` and ``falcon-mamba-7b`` at full size,
    ``qwen2-vl-72b`` (cut to 2 layers, with the vision stub's patch
    embeddings and M-RoPE positions), ``deepseek-v2-236b`` (cut to 2
    layers: MLA and 160 routed experts + 2 shared), ``grok-1-314b`` (cut
    to 1 layer) and ``whisper-tiny`` at full size (the 1500-frame encoder
    stub), each in bf16 activations with float32 weights from a seed,
    batch 4, a 1024-token prompt, 32 new tokens through
    ``launch.serve.generate``, with the counts set to 0 just before and
    read just after (one tensor-core attention launch a layer a call, two
    for whisper's decoder and one an encoder layer in prefill; one scan a
    Mamba layer a call): prefill s, decode ms/token, tokens/s, peak device
    memory, launches per request; logits finite and a second run giving
    the same tokens; one internlm2 decode step's device time, kernels and
    busy share from ``torch.profiler``; each model freed before the next;
    (b) one full-width card-vs-CPU check a family (internlm2 at 2 layers,
    falcon-mamba, qwen2-vl and deepseek-v2 at 1, whisper-tiny in full),
    float32, one seeded weight set on both devices, batch 1, a 64-token
    prompt: forward and prefill logits and 4 greedy decode steps (logits
    and every cache leaf) within 1e-3, the float32 (3xTF32) attention
    kernels counted, every launch a tensor-core one; for deepseek-v2 each
    token's routed experts compared first (a
    difference fails unless the swapped experts' probabilities are within
    1e-5: such a tie is printed and counted);
17. training on the card (phase 2 built the two backward kernels,
    ``flash_attention_bwd.cu`` with ``flash_attention_bwd_wgmma.cu`` and
    ``flash_attention_bwd_tf32.cu`` into
    the attention library and ``mamba_scan_bwd.cu`` into the scan's):
    (a) each backward kernel against its plain version on the same
    residuals: attention in float32 (the 3xTF32 tensor-core kernels;
    3e-5, the reference's gradient tolerance) and bfloat16 (the
    tensor-core kernels:
    against ``flash_attention_bwd_tc_mirror``, their arithmetic, within
    two bf16 roundings plus 1e-4 of the largest gradient, at most 64
    elements a tensor past that and each within 2^-7 of the tensor's
    largest magnitude (a P or dS rounded to the neighbouring bf16 value),
    and against the
    float32 plain version on the same inputs, each gradient within twice
    the error of ``scaled_dot_product_attention``'s backward against that
    version, measured beside it) at Hymba's training shape (4, 1152, 25 / 5
    heads, 64, window 1024), internlm2's (1, 1024, 16 / 8, 128, causal),
    MLA's head dims (1, 512, 16 heads, 192 / 128), whisper's encoder (1,
    1500, 6, 64, ``none``), a ragged ``kv_valid_len`` and small head dims,
    with the forward's log-sum-exp against the plain one and the blocks
    an SM holds of each bf16 backward kernel; the scan (1e-4, its forward's
    chunk states against the plain ones, the backward from them) at Hymba's
    width, at Falcon-Mamba's (8192) with h0 and a gradient on h_T, and at
    ragged shapes, with its split of the card and the training forward
    (writing the chunk states) timed beside serving's; every call twice, bitwise
    equal; the main shapes timed beside their bound (for the scan the
    larger of its byte bound and its floor of one exponential a (b, t, di,
    n) on the special-function units, both printed), the plain version
    and, for attention, the backward of ``scaled_dot_product_attention``
    under autograd (its forward subtracted);
    (b) one ``make_train_step`` of Hymba at full width and 2 layers,
    float32, batch 1, 64 tokens: the card (kernels, counted) against the
    CPU (plain versions): each gradient tensor within 2e-5 of its largest
    magnitude plus rtol 1e-4, loss and gradient norm within rtol 1e-4, the
    updated weights with a gradient clear of the noise within 1e-6 and the
    others within 2 lr;
    (c) ``hymba-1.5b`` as configured (32 layers, bf16 activations, float32
    weights, remat ``dots`` in groups of 4), AdamW with bf16 moments (lr
    3e-4, 2 warmup steps), 6 steps of ``SyntheticLM`` batches (4 x 1024
    tokens, 1152 positions with the meta tokens) through ``train_loop``,
    with the counts set to 0 just before and read just after (each layer's
    attention and scan forward twice a step, its recomputation included,
    and backward once): every loss finite and the last below the first;
    step walls, tokens/s, the optimizer's share, peak device memory, and
    the last step's device time and kernels from ``torch.profiler``;
    (d) ``FaultTolerantTrainer`` on the reduced Hymba with a
    ``CheckpointManager`` in a temporary directory (a checkpoint every 2
    steps) and a ``TransientError`` injected once at step 3: one restart,
    6 steps; a second trainer on the directory resumes at step 6, its first
    loss bit for bit the loss of the first trainer's state continued.
18. the front door's tail and the planning layer on the card: (a) the
    deprecated ``optimize``, ``two_stage_optimize`` and module-level
    ``explore`` on the reference shim test's small problem (SA 4 steps, 2
    chains, 2 + 2 restarts; NSGA pop 8, 2 generations): each warns once
    and equals, bit for bit, the ``Session.submit`` it routes through with
    the same key;
    ``monolithic_cost`` on the card against the CPU (rtol 1e-6); (b) phase
    11's first generation (tokens and logits) against the digest recorded
    from the tree before the kernels became custom operators, bit for bit;
    (c) ``launch.graph_analysis.analyze`` of phase 17 (c)'s train step on
    fake CUDA tensors from ``train_state_specs`` (no kernel launched:
    every counter unchanged): each kernel operator's calls times its
    launches a call against phase 17 (c)'s launches a step
    (its counters and its profiled step), the traced peak of live bytes
    against ``max_memory_allocated``, the model FLOPs (6 N D) over the
    profiled step's device time and over the step wall at the bf16 peak;
    one decode step of phase 11 traced the same way, its compulsory bytes
    at the HBM rate against the decode step's device time; (d) the
    advisor's ``bo_search`` for qwen2-72b ``train_4k`` at 256 cards,
    budget 32, with the GP on the card (``gp_cov`` launches counted) beside
    ``exhaustive_best``.
19. the multi-rank half on the one card: (a) phase 5's query with
    ``Session(mesh=make_island_mesh(4))``, 4 islands of 16 on cuda:0: its
    wall, evaluations/s and ``pareto_rank`` launches beside phase 5's, its
    front hypervolume beside phase 5's; a 1-island mesh equal to phase 5's
    run bit for bit; the island count changing the checkpoint signature;
    (b) phase 11's generation with the parameters as DTensors on a
    one-rank NCCL world's (1, 1) ("data", "model") mesh, through the
    kernels' sharding rules and the activation-sharding context: tokens
    and logits bit for bit phase 11's, the same launches; (c) the reduced
    Hymba's DTensor train state after a step on that mesh, saved, restored
    into plain tensors and into DTensors, bit for bit; (d) the dry run's
    qwen2-72b ``decode_32k`` cell on the single (16, 16) mesh of a
    256-rank fake world, on fake CUDA tensors (no launch): per-device
    FLOPs, bytes, wire bytes by kind, the traced peak and the roofline
    beside the advisor's ``predict`` of the same layout (``train_4k``
    unrolls ~1k operators a layer a microbatch, past the phase's minute).

The last lines are the kernels JSON line, the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --loss-drift

runs only phase 17 (c)'s 6 seeded steps, once for each way of taking the
attention backward: the port's (bf16 on the tensor cores; twice, to show
the trajectory repeats), ``scaled_dot_product_attention``'s backward
swapped in by this script alone (the library's own bf16 rounding), and
the port's float32 kernels (3xTF32 on the tensor cores) on float32 copies
of the same inputs (no rounding but the result's and 3xTF32's, about
2^-21 a product); it prints each arm's losses and the largest
differences between them, one JSON line.  Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.api import (Problem, Query, RunControl,  # noqa: E402
                             Session)
from repro_torch.calib import (CalibratedTech,  # noqa: E402
                               baseline_measurements, fit, load_calibrated,
                               simulator_sweep)
from repro_torch.calib.fit import DEFAULT_FREE  # noqa: E402
from repro_torch.calib.measurements import SWEEP_SHAPES  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import presets  # noqa: E402
from repro_torch.core.constants import (DEFAULT_TECH,  # noqa: E402
                                        FITTABLE_FIELDS, METRIC_FIELDS,
                                        tech_key)
from repro_torch.core.encoding import (DesignSpace,  # noqa: E402
                                       feasibility_penalty, migrate,
                                       random_design)
from repro_torch.core.evaluate import (SystemSpec,  # noqa: E402
                                       evaluate_system, make_batch_evaluator)
from repro_torch.core.optimizer import (METRIC_KEYS, OBJ_EDP,  # noqa: E402
                                        SAConfig, gp_posterior, make_sa,
                                        metric_stack, objective_from_metrics,
                                        prob_improvement)
from repro_torch.core.workload import (MAX_LOOPS,  # noqa: E402
                                       WorkloadGraph, matmul)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.explore.archive import (HV_LOG_REF,  # noqa: E402
                                         MANIFEST_NAME, ArchiveManifest,
                                         ManifestPolicy, ParetoArchive,
                                         hypervolume_2d, pareto_front)
from repro_torch.explore.nsga import (NSGAConfig, make_nsga,  # noqa: E402
                                      make_nsga_fused)
from repro_torch.explore import quantize  # noqa: E402
from repro_torch.explore.service import BudgetPolicy  # noqa: E402
from repro_torch.kernels.gp_cov import cost as gp_cost  # noqa: E402
from repro_torch.kernels.gp_cov import ops as gp_ops  # noqa: E402
from repro_torch.kernels.flash_attention import cost as fa_cost  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, attention_ref, flash_attention_blocked,
    flash_attention_bwd_blocked, flash_attention_bwd_tc_mirror,
    tc_bwd_agreement, TC_BWD_ATOL_OF_MAX, TC_BWD_MAX_PAST,
    TC_BWD_PAST_OF_MAX, TC_BWD_RTOL)
from repro_torch.kernels.gp_cov.ref import matern52_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import cost as ms_cost  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    selective_scan_bwd_ref, selective_scan_ref)
from repro_torch.autosharding.advisor import (ShardPlan,  # noqa: E402
                                              bo_search, exhaustive_best,
                                              predict)
from repro_torch.core.constants import DEFAULT_H100  # noqa: E402
from repro_torch.core.cost import monolithic_cost  # noqa: E402
from repro_torch.core.optimizer import optimize as legacy_optimize  # noqa: E402
from repro_torch.core.optimizer import (  # noqa: E402
    two_stage_optimize as legacy_two_stage)
from repro_torch.explore.service import ExplorationService  # noqa: E402
from repro_torch.explore.service import explore as legacy_explore  # noqa: E402
from repro_torch.launch.dryrun import (default_parallel,  # noqa: E402
                                       lower_cell, model_flops_for,
                                       model_min_bytes_for)
from repro_torch.launch.mesh import make_island_mesh  # noqa: E402
from repro_torch.launch.graph_analysis import analyze, roofline  # noqa: E402
from repro_torch.launch.serve import generate, stub_inputs  # noqa: E402
from repro_torch.launch.specs import (batch_specs, cache_specs,  # noqa: E402
                                      params_specs, sds)
from repro_torch.launch.train import (make_train_state,  # noqa: E402
                                      make_train_step, train_loop,
                                      train_state_specs)
from repro_torch.models import layers as Ly  # noqa: E402
from repro_torch.models import transformer as Tr  # noqa: E402
from repro_torch.models.config import (SHAPES, ParallelConfig,  # noqa: E402
                                       ShapeConfig)
from repro_torch.parallel import sharding as Sh  # noqa: E402
from repro_torch.parallel.ctx import activation_sharding  # noqa: E402
from repro_torch.models.model import build_model, lm_module  # noqa: E402
from repro_torch.kernels.pareto_rank import cost as pareto_cost  # noqa: E402
from repro_torch.kernels.pareto_rank import ops as pareto_ops  # noqa: E402
from repro_torch.kernels.pareto_rank.ref import dominance_counts_ref  # noqa: E402
from repro_torch.obs.report import render  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig,  # noqa: E402
                                     adamw_init, adamw_update)
from repro_torch.runtime.driver import (FaultTolerantTrainer,  # noqa: E402
                                        TransientError)
from repro_torch.serve import (CANCELLED, DONE, RUNNING,  # noqa: E402
                               CancelledError, Executor, JobStore,
                               query_to_payload)

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
# TF32 on the tensor cores: a float32-accurate product takes three of them
# (3xTF32, the float32 attention kernels), so float32 attention operations
# are charged 3 / PEAK_TF32_OPS_PER_S each
PEAK_TF32_OPS_PER_S = 495e12

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

# the README's quickstart query (examples/quickstart.py), its SA steps cut
# 250 -> 50 to keep the whole run well inside its time limit: the BO
# rounds, chains and gp_cov launches are the README's
QUICK_OPTS = dict(n_init=4, n_iter=8)
QUICK_SA = SAConfig(steps=50, chains=4)
TWO_STAGE_SA = SAConfig(steps=10, chains=4)

# flash_attention checks: (B, Sq, Sk, H, KV, D, Dv, mask, window,
# kv_valid_len, tag).  The reference kernel test's FA_SHAPES
# (tests/test_kernels.py), two shapes with Dv != D, the Hymba prefill shape
# (prompt 1024 + 128 meta tokens, 25 query heads over 5 KV heads, window
# 1024), a ragged Sq = Sk = 1000, a kv_valid_len that is not a multiple of
# the kernels' tiles, the families' serving shapes (below), and the float32
# key-split path's edges: MLA's head dims at 4 heads, a key count that
# leaves a ragged last split, 3 queries of a 2-head group, and head dims
# that are not multiples of 8 (float32 only; bf16 must refuse them)
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
              "head dim 128"),
             (4, 1024, 1057, 16, 8, 128, 128, "causal", 0, 1024,
              "internlm2 prefill"),
             (4, 1, 1057, 16, 8, 128, 128, "causal", 0, 1025,
              "internlm2 decode"),
             (4, 1, 1057, 128, 128, 192, 128, "causal", 0, 1025,
              "MLA decode"),
             (4, 1, 1500, 6, 6, 64, 64, "none", 0, None, "whisper cross"),
             (4, 1024, 1057, 128, 128, 192, 128, "causal", 0, 1024,
              "MLA prefill"),
             (4, 1024, 1057, 64, 8, 128, 128, "causal", 0, 1024,
              "qwen2-vl prefill"),
             (4, 1, 1057, 64, 8, 128, 128, "causal", 0, 1025,
              "qwen2-vl decode"),
             (4, 1024, 1057, 48, 8, 128, 128, "causal", 0, 1024,
              "grok-1 prefill"),
             (4, 1, 1057, 48, 8, 128, 128, "causal", 0, 1025,
              "grok-1 decode"),
             (4, 1500, 1500, 6, 6, 64, 64, "none", 0, None,
              "whisper encoder"),
             (4, 1024, 1057, 6, 6, 64, 64, "causal", 0, 1024,
              "whisper prefill"),
             (4, 1, 1057, 6, 6, 64, 64, "causal", 0, 1025, "whisper decode"),
             (4, 1024, 1500, 6, 6, 64, 64, "none", 0, None,
              "whisper cross prefill"),
             (4, 1, 1057, 4, 4, 192, 128, "causal", 0, 1025,
              "MLA decode 4 heads"),
             (2, 1, 700, 16, 8, 128, 128, "causal", 0, 650, "ragged split"),
             (1, 3, 300, 4, 2, 64, 64, "causal", 0, 290, "3 queries"),
             (2, 77, 90, 4, 2, 36, 20, "causal", 0, None, "head dim 36"),
             (2, 1, 333, 8, 1, 37, 53, "window", 100, 300, "head dim 37"))
# the families' serving shapes (phase 16, batch 4, a 1024-token prompt, a
# cache of 1024 + 32 + 1 positions): each family's prefill into the longer
# cache (kv_valid_len 1024) and its decode step (one query at offset
# 1024), DeepSeek-V2's MLA at full width (192 / 128 over 128 heads),
# whisper's encoder over its 1500 frames and its decoder's
# cross-attention over them.  Phase 16 fails if its main path launches
# attention at a shape that is not in FA_SHAPES.
FA_FAMILY_TAGS = ("internlm2 prefill", "internlm2 decode", "MLA prefill",
                  "MLA decode", "qwen2-vl prefill", "qwen2-vl decode",
                  "grok-1 prefill", "grok-1 decode", "whisper encoder",
                  "whisper prefill", "whisper decode",
                  "whisper cross prefill", "whisper cross")
# held to the serving tolerance (bf16) and timed
FA_SERVE_TAGS = ("hymba prefill", "ragged", "kv_valid_len",
                 "deepseek-v2 width") + FA_FAMILY_TAGS
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
# Falcon-Mamba-7B (d_inner 8192): its prefill scan continues from the
# cache's (zero) state, so it is timed with h0, as is its decode step
MS_FM_PREFILL = (4, 1024, 8192, 16, "falcon-mamba prefill")
MS_FM_DECODE = (4, 1, 8192, 16, "falcon-mamba decode")
MS_SHAPES = ((1, 16, 8, 4, "kernel test"), (2, 32, 16, 8, "kernel test"),
             (1, 64, 32, 16, "kernel test"), MS_PREFILL, MS_DECODE,
             MS_HYMBA_A, (1, 5, 33, 16, "ragged"), (2, 37, 70, 3, "ragged"),
             (1, 40, 64, 1, "ragged"), (3, 77, 130, 32, "ragged"),
             MS_FM_PREFILL, MS_FM_DECODE)
# the timed shapes, each with the h0 its serving path passes
MS_TIMED = {MS_PREFILL: False, MS_DECODE: True, MS_FM_PREFILL: True,
            MS_FM_DECODE: True}
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


def bound_of(t_ops_ms: float, nbytes) -> tuple:
    """(ms, "operations" | "bytes"): the larger of the operations' time and
    the time of ``nbytes`` at the memory rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops_ms, "operations") if t_ops_ms >= t_bytes \
        else (t_bytes, "bytes")


def pareto_bound_ms(n: int, k: int) -> tuple:
    """Least time for one dominance count (``pareto_rank/cost.py``: n*(4k+1)
    bytes read and 4n written, n^2 pairs x 2k FP32 compares) at the memory
    rate and the FP32 rate, whichever is larger."""
    ops, nbytes = pareto_cost.dominance_work(n, k)
    return bound_of(ops / PEAK_FP32_OPS_PER_S * 1e3, nbytes)


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
    """Least time for one covariance (``gp_cov/cost.py``: 4 (n + m) d bytes
    read and 4 n m written, n m (3 d + 15) FP32 operations) at the memory
    rate and the FP32 rate, whichever is larger."""
    ops, nbytes = gp_cost.matern_work(n, m, d)
    return bound_of(ops / PEAK_FP32_OPS_PER_S * 1e3, nbytes)


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


visible_pairs = fa_cost.visible_pairs


def tensor_core_op_s(dtype) -> float:
    """Seconds an attention operation takes at the tensor cores' rate for
    the input type: bf16, or for float32 three TF32 operations (3xTF32,
    the least a float32-accurate product takes there)."""
    return 1 / PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 \
        else 3 / PEAK_TF32_OPS_PER_S


def fa_bound_ms(B, Sq, Sk, H, KV, D, Dv, mask, window, kvl,
                dtype) -> tuple:
    """Least time for one attention (``flash_attention/cost.py``: q, the
    first ``kv_valid_len`` rows of k and v read once and out written once;
    2 (D + Dv) operations a visible (q, k) pair and head) at the memory
    rate and the tensor cores' rate for the input type, whichever is
    larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    ops, nbytes = fa_cost.forward_work(B, Sq, Sk, H, KV, D, Dv, mask, window,
                                       kvl, size)
    return bound_of(ops * tensor_core_op_s(dtype) * 1e3, nbytes)


# the float32 kernels' products (3xTF32 on wgmma) against float64, as
# max |c - a b^T| / (|a| |b|^T): at most this, where one TF32 product is
# off by about 2^-11 of a term
TF32X3_PROBE_BOUND = 2.0 ** -19


def tf32_probe_report() -> dict:
    """``fa_ops.tf32_probe`` at D = 64, 128 and 192 on seeded normal
    inputs: the largest error of a 64 x 64 product against float64 over the
    sum of its terms' magnitudes, with three TF32 products and with one;
    fails if three miss ``TF32X3_PROBE_BOUND``."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    out = {}
    for D in (64, 128, 192):
        a = torch.randn(64, D, generator=gen, device="cuda")
        b = torch.randn(64, D, generator=gen, device="cuda")
        want = a.double() @ b.double().T
        mag = a.double().abs() @ b.double().abs().T
        out[D] = {f"products_{n}": float(
            ((fa_ops.tf32_probe(a, b, n).double() - want).abs() / mag).max())
            for n in (3, 1)}
        out[D]["float32"] = float(((a @ b.T).double() - want).abs().div(
            mag).max())
        if not out[D]["products_3"] <= TF32X3_PROBE_BOUND:
            fail(f"3xTF32 on wgmma at D = {D}: error {out[D]['products_3']}"
                 f" of the terms' magnitudes > {TF32X3_PROBE_BOUND}")
    print(f"3xTF32 probe (64 x 64 x D on wgmma against float64, max error "
          f"over the sum of the terms' magnitudes; 3 products, 1, and a "
          f"float32 matmul): {json.dumps(out)}")
    return out


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
            if dt == torch.bfloat16 and (D % 8 or Dv % 8):
                # the bf16 kernel takes head dims that are multiples of 8
                try:
                    fa_ops.flash_attention(q, k, v, mask, w, kvl)
                except ValueError:
                    continue
                fail(f"flash_attention took bf16 head dims {(D, Dv)}")
            tc_before = fa_ops.flash_attention.launches_tc
            again = fa_ops.flash_attention(q, k, v, mask, w, kvl)
            got = fa_ops.flash_attention(q, k, v, mask, w, kvl)
            torch.cuda.synchronize()
            tc = fa_ops.flash_attention.launches_tc - tc_before
            if tc != 2:
                fail(f"flash_attention at {shape[:-1]} {dt} moved the "
                     f"tensor-core count by {tc} in 2 calls (both dtypes "
                     f"run on tensor cores)")
            if not torch.equal(got, again):
                fail(f"flash_attention at {shape[:-1]} {dt}: two calls on "
                     f"the same inputs differ")
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
            if tag in FA_FAMILY_TAGS and Sq == 1:
                row["device_ms"] = device_ms_per_launch(
                    lambda: fa_ops.flash_attention(q, k, v, mask, w, kvl),
                    "attn_fwd_wgmma_kernel" if dt == torch.bfloat16
                    else "attn_fwd_split_tf32_kernel")
            rows.append(row)
            timing = (f", kernel {row['ms'] * 1e3:.2f} us, plain "
                      f"{row['plain_ms'] * 1e3:.2f} us, sdpa "
                      f"{row['library_ms'] * 1e3:.2f} us, bound "
                      f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})"
                      if "ms" in row else "")
            if row.get("device_ms") is not None:
                timing += (f", device {row['device_ms'] * 1e3:.2f} us per "
                           f"launch")
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
    """Least time for one scan (``mamba_scan/cost.py``: u, delta, A, Bc, Cc
    (and h0) read once and y, h_T written once; 6 FP32 operations a (b, t,
    di, n)) at the memory rate and the FP32 rate, whichever is larger."""
    ops, nbytes = ms_cost.forward_work(B, S, Di, Ds, with_h0)
    return bound_of(ops / PEAK_FP32_OPS_PER_S * 1e3, nbytes)


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
            if MS_TIMED.get(shape) == with_h0:
                k_ms = cuda_ms(lambda: ms_ops.selective_scan(u, dl, A, Bc,
                                                             Cc, h0), 50)
                p_ms = cuda_ms(lambda: selective_scan_ref(u, dl, A, Bc, Cc,
                                                          h0),
                               3 if S > 1 else 50)
                b_ms, b_by = ms_bound_ms(B, S, Di, Ds, with_h0)
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
                if S == 1:
                    row["device_ms"] = device_ms_per_launch(
                        lambda: ms_ops.selective_scan(u, dl, A, Bc, Cc, h0),
                        "scan_kernel")
            rows.append(row)
            timing = (f", kernel {row['ms'] * 1e3:.2f} us, plain "
                      f"{row['plain_ms'] * 1e3:.2f} us, bound "
                      f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})"
                      if "ms" in row else "")
            if row.get("device_ms") is not None:
                timing += (f", device {row['device_ms'] * 1e3:.3f} us per "
                           f"launch")
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
    params_cpu = lm_module(cfg, "cpu")
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
        for j, (a, b) in enumerate(zip(Tr.tree_leaves(cache),
                                       Tr.tree_leaves(cache_c))):
            compare(f"cache leaf {j}", a, b)
    wall = time.perf_counter() - t0
    launches = dict(flash_attention=fa_ops.flash_attention.launches,
                    tensor_core=fa_ops.flash_attention.launches_tc)
    want = dict(flash_attention=2 * cfg.n_layers,
                tensor_core=2 * cfg.n_layers)
    if launches != want:
        fail(f"hymba card vs CPU launched {launches}, expected {want} (the "
             f"float32 3xTF32 tensor-core kernel in the forward and the "
             f"prefill)")
    print(f"hymba card vs CPU (d {cfg.d_model}, {cfg.n_layers} layers, "
          f"float32, prompt {prompt.shape[1]} + {cfg.meta_tokens} meta, "
          f"window {cfg.window}, {n_new} decode "
          f"steps): max abs err {json.dumps(errs)} (gate {LM_PARITY_TOL}); "
          f"{wall:.1f} s; attention launches {launches}")
    return dict(max_abs_err=errs, gate=LM_PARITY_TOL, wall_s=wall,
                launches=launches)


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
               digest=generation_digest(first),
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


def generation_digest(gen) -> str:
    """sha256 of a generation's tokens and last logits, their bytes as they
    lie on the card (phase 18 (b) holds phase 11's to a recorded one)."""
    h = hashlib.sha256()
    for t in (gen.tokens, gen.logits):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


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
        args = [g for g in name.groups()[1:] if g is not None]
        kernels[f"{name[1]}<{','.join(args)}>"] = dict(
            registers=num(r"Used (\d+) registers"),
            static_smem_bytes=num(r"(\d+) bytes smem"),
            spill_stores=num(r"(\d+) bytes spill stores"),
            spill_loads=num(r"(\d+) bytes spill loads"),
            stack_frame_bytes=num(r"(\d+) bytes stack frame"))
    return kernels


def hgmma_by_function(lib: Path):
    """{mangled function name: HGMMA (wgmma) instructions in its SASS} of a
    library, from ``cuobjdump -sass``; None where it is not installed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        out[name] = out.get(name, 0) + chunk.count("HGMMA")
    return out


def attention_build_report(lib: Path) -> dict:
    """The attention kernels' ``ptxas_report`` (registers, spills) and the
    count of ``HGMMA`` (wgmma) instructions in the library's SASS, in all
    and per kernel, where ``cuobjdump`` is installed: the forward kernels
    (bf16 ``attn_fwd_wgmma_kernel<PD,PV>``; float32, 3xTF32, the tile
    kernel ``attn_fwd_tf32_kernel<PD,PV,WG>`` and the key-split kernel
    ``attn_fwd_split_tf32_kernel<PD,PV>``) and the backward's dk / dv and
    dq kernels (bf16 ``..._wgmma_kernel<PD,PV[,BQ]>``, float32
    ``..._tf32_kernel<PD,PV>``), three head-dim classes each.  Fails if an
    instantiation is missing, if a kernel has no HGMMA, or if the build
    names a float32 SIMT attention kernel (``attn_fwd_kernel``,
    ``attn_bwd_{dq,dkdv}_kernel<float>``), which no longer exists."""
    log = lib.with_suffix(".log").read_text()
    if re.search(r"attn_fwd_kernel|attn_bwd_(?:dq|dkdv)_kernelIf", log):
        fail("the flash_attention build names a float32 SIMT attention "
             "kernel")
    hgmma = hgmma_by_function(lib)

    def counted(recs: dict, want: int, what: str) -> dict:
        if len(recs) != want:
            fail(f"the flash_attention build log names {len(recs)} {what}, "
                 f"not {want}: {sorted(recs)}")
        if hgmma is None:
            return recs
        for name, rec in recs.items():
            kind = name.split("<")[0]
            dims = name[name.index("<") + 1:-1].split(",")
            mangled = [f for f in hgmma if kind in f and "ILi" + "ELi".join(
                dims) + "E" in f]
            rec["hgmma"] = sum(hgmma[f] for f in mangled)
            if rec["hgmma"] == 0:
                fail(f"the attention kernel {name} holds no HGMMA "
                     f"instruction")
        return recs

    fwd_bf16 = counted(ptxas_report(
        lib, r"(attn_fwd_wgmma_kernel)ILi(\d+)ELi(\d+)E"), 3,
        "bf16 forward kernels (3 classes)")
    fwd_f32 = counted(ptxas_report(
        lib, r"(attn_fwd_(?:split_)?tf32_kernel)ILi(\d+)ELi(\d+)E"
             r"(?:Li(\d+)E)?"), 6,
        "float32 forward kernels (tile and key-split, 3 classes)")
    out = dict(kernels={**fwd_bf16, **fwd_f32},
               hgmma="not checked (no cuobjdump)")
    if hgmma is not None:
        out["hgmma"] = sum(hgmma.values())
    for name in ("attn_fwd_wgmma_kernel<192,128>",
                 "attn_fwd_tf32_kernel<192,128,1>",
                 "attn_fwd_split_tf32_kernel<192,128>"):
        if name not in out["kernels"]:
            fail(f"the flash_attention build log names no {name} (MLA's "
                 f"head dims)")
    print(f"flash_attention build (registers, spills, HGMMA in the SASS): "
          f"{json.dumps(out['kernels'])}; HGMMA instructions in all: "
          f"{out['hgmma']}")
    # the dk / dv and dq kernels, 3 classes (PD, PV, and the bf16 dk / dv
    # kernel's query tile BQ) of each type
    f32 = counted(ptxas_report(
        lib, r"(attn_bwd_(?:dq|dkdv)_tf32_kernel)ILi(\d+)ELi(\d+)E"), 6,
        "float32 (3xTF32) backward kernels (dq and dk / dv, 3 classes)")
    tc = counted(ptxas_report(
        lib, r"(attn_bwd_(?:dq|dkdv)_wgmma_kernel)ILi(\d+)ELi(\d+)E"
             r"(?:Li(\d+)E)?"), 6,
        "bf16 backward kernels (dq and dk / dv, 3 classes)")
    out["backward"] = dict(tf32_float32=f32, wgmma_bf16=tc)
    print(f"flash_attention backward build (registers, spills, HGMMA in the "
          f"SASS): float32 3xTF32 {json.dumps(f32)}; bf16 {json.dumps(tc)}")
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
    """The scan kernels' ``ptxas_report`` (the forward: one instantiation
    per state-size class — states a thread, threads a channel, steps
    ahead — and per kept-states flag, 1 for training; fails if one spills;
    the backward: one per state-size class, reported)."""
    kernels = ptxas_report(
        lib, r"(scan_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E")
    if not kernels:
        fail("the mamba_scan build log names no scan_kernel")
    spills = {k: v for k, v in kernels.items()
              if v["spill_stores"] or v["spill_loads"]}
    if spills:
        fail(f"mamba_scan kernels spill registers: {json.dumps(spills)}")
    print(f"mamba_scan build: {json.dumps(kernels)}")
    bwd = ptxas_report(lib, r"(scan_bwd_kernel)ILi(\d+)ELi(\d+)E")
    if len(bwd) != 6:
        fail(f"the mamba_scan build log names {len(bwd)} backward kernels, "
             f"not 6 (one a state-size class: states a thread, threads a "
             f"channel)")
    print(f"mamba_scan backward build: {json.dumps(bwd)}")
    return dict(forward=kernels, backward=bwd)


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


def check_front(problem, result, tech=DEFAULT_TECH):
    fr = result.front_objs
    if fr.shape[0] == 0 or fr.shape[1] != 2 or not np.all(np.isfinite(fr)):
        fail(f"bad front {fr.shape}")
    designs = {k: torch.as_tensor(np.stack([d[k] for d in
                                            result.front_designs]),
                                  device="cuda")
               for k in result.front_designs[0]}
    m = evaluate_system(problem.spec, designs, tech)
    pen = feasibility_penalty(problem.space, designs, m)
    if float(pen.max()) > 1.0 + 1e-6:
        fail("the served front holds an infeasible design")
    again = metric_stack(m).double().cpu().numpy()
    np.testing.assert_allclose(again, result.front_metrics, rtol=1e-5,
                               err_msg="front metrics do not re-evaluate")


# spin kernels that open every profiled call (``device_by_kernel``)
PROFILE_LEAD_IN = 256


def device_by_kernel(fn, host: bool = True) -> tuple:
    """(device seconds, kernel count, {kernel name: (device seconds,
    count)}) of one synchronized call of ``fn`` under ``torch.profiler``;
    (0, 0, {}) when it sees no device events.  ``host=False`` traces the
    device alone (far lighter on a call of tens of thousands of
    launches).  The trace opens with ``PROFILE_LEAD_IN`` spin kernels,
    left out of what it returns: a record the profiler loses as it starts
    is then one of theirs, not one of ``fn``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.key]
    return (sum(e.self_device_time_total for e in dev) * 1e-6,
            sum(e.count for e in dev),
            {e.key: (e.self_device_time_total * 1e-6, e.count) for e in dev})


def kernel_split(by_name: dict, total_s: float, top: int = 5) -> dict:
    """Device seconds of the port's LM kernels (the attention forward
    kernels, all on tensor cores, the scan, the two backward passes) and of
    the ``top`` kernels by device time, each with its share of
    ``total_s``."""
    def share(keys):
        t = sum(by_name[k][0] for k in keys)
        return dict(s=t, share=t / total_s if total_s > 0 else 0.0,
                    count=sum(by_name[k][1] for k in keys))
    out = {name: share([k for k in by_name if any(t in k for t in tags)])
           for name, tags in (
               ("flash_attention_tc", ("attn_fwd_wgmma_kernel",
                                       "attn_fwd_tf32_kernel",
                                       "attn_fwd_split_tf32_kernel")),
               ("mamba_scan", ("scan_kernel",)),
               ("flash_attention_bwd", ("attn_bwd_",)),
               ("mamba_scan_bwd", ("scan_bwd_kernel",
                                   "sum_partials_kernel")))}
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


# ---------------------------------------------------------------------------
# phase 12: transfer, fleet cache and resume on the card
# ---------------------------------------------------------------------------
# the reference's transfer benchmark scenario (benchmarks/bench_transfer.py
# :50-166) at its full budget: a bounded space (<= 2x2 core / 1x2 chiplet
# arrays), the two attention neighbors and the held-out qwen2.5-32b block
TR_OBJ = ("latency_ns", "cost_usd")
TR_SPACE_KW = dict(max_shape=(8, 8, 2, 2, 1, 2))
TR_CH_MAX = 2
TR_NSGA_KW = dict(pop=32, immigrants=0.0, mutations=1)
TR_POLICY_KW = dict(adaptive=False, reallocate=False)
# the reference benchmark's key and the next four.  Its hypervolume
# conditions are single draws of a random search, which the reference's
# own run also misses at some keys (``tests/torch_transfer_gates.py``
# reads both packages key by key on the CPU; PERF.md keeps the counts),
# so they are held on the runs pooled over these keys: the mean of the
# per-key hypervolumes for (a), the mean seeded trace against the mean
# unseeded final hypervolume for (b).  Every key's spend, neighbors and
# manifest bound are asserted as the reference asserts them, and at least
# TR_MIN_ALONE keys must meet each gate on their own (the reference meets
# each alone at about 4 keys in 5 on the CPU), so a transfer that is a
# little weaker at every key fails even where the pool would not
TR_KEYS = (42, 43, 44, 45, 46)
TR_MIN_ALONE = 2
TR_KEY = TR_KEYS[0]
TR_BUDGET = 4096
TR_NEIGHBORS = ("attn_qwen2_72b", "attn_internlm2")
TR_HELD_OUT = "attn_qwen2_5_32b"
# (d): two writers at once into one directory, then a third process
FLEET_WRITERS = ("attn_qwen2_72b", "mlp_qwen2_72b")
FLEET_READER = "attn_internlm2"
FLEET_BUDGET = 1024
FLEET_TIMEOUT_S = 300
# (e): DEFAULT_TECH with the per-hop router delay (t_s) halved
TECH_NAME = "smoke_fast_router"
TECH_BUDGET = 512


@dataclasses.dataclass(frozen=True)
class Package:
    """What the transfer arms use of a search package: its API classes,
    its workload library, its key type and a device barrier.  ``CARD`` is
    the port on the card; ``tests/torch_transfer_gates.py`` passes the
    port on the CPU and the JAX reference, to read the gates' statistics
    through the same arms."""
    Session: object
    Query: object
    Problem: object
    NSGAConfig: object
    BudgetPolicy: object
    ManifestPolicy: object
    library: object
    key: object = int
    sync: object = torch.cuda.synchronize


CARD = Package(functools.partial(Session, device="cuda"), Query, Problem,
               NSGAConfig, BudgetPolicy, ManifestPolicy,
               presets.workload_library)

# one fleet process: a transfer query into the shared cache directory.  A
# writer waits for the parent's go file after its imports, so both
# writers submit at once; a reader plans first, then submits
FLEET_CHILD = r"""
import json, sys, time
from pathlib import Path
repo, cache, name, mode = sys.argv[1:5]
sys.path.insert(0, repo)
import chip_smoke as cs
s = cs.tr_session(Path(cache))
q = cs.Query(cs.tr_problem(name), budget=cs.FLEET_BUDGET, transfer=True)
out = dict(graph=name)
if mode == "read":
    out["plan"] = [[n.key, n.distance, n.quota] for n in s.plan(q).neighbors]
else:
    Path(cache, ".ready-" + name).touch()
    while not Path(cache, ".go").exists():
        time.sleep(0.002)
r, rec = cs.timed_submit(s, q, key=cs.TR_KEY)
pv = r.provenance
out.update(rec, key=pv.cache_key, seeds=pv.n_transfer_seeds,
           transferred_from=list(pv.transferred_from))
print(json.dumps(out))
"""


# one key of (a) and (b) in a process of its own: the keys run at once
TR_CHILD = r"""
import json, sys
from pathlib import Path
repo, root, key = sys.argv[1:4]
sys.path.insert(0, repo)
import chip_smoke
chip_smoke.torch.set_num_threads(1)    # five at once share the host's cores
out, warm = chip_smoke.transfer_arms(Path(root), int(key))
out["front_designs"] = [{k: v.tolist() for k, v in d.items()}
                        for d in warm.front_designs]
print(json.dumps(out))
"""
TR_TIMEOUT_S = 600


def launch_counts() -> dict:
    return dict(pareto_rank=pareto_ops.dominance_counts.launches,
                gp_cov=gp_ops.matern52.launches)


def timed_submit(session, query, sync=torch.cuda.synchronize, **kw):
    """``session.submit(query, **kw)`` with its synchronized wall seconds,
    evaluations, evaluations/s and kernel launches: (result, record)."""
    before = launch_counts()
    sync()
    t0 = time.perf_counter()
    r = session.submit(query, **kw)
    sync()
    wall = time.perf_counter() - t0
    n = r.provenance.n_evals_run
    return r, dict(wall_s=wall, evals=n, evals_per_s=n / wall,
                   launches={k: v - before[k]
                             for k, v in launch_counts().items()})


def print_arm(tag: str, rec: dict):
    extra = "".join(f", {k} {rec[k]}" for k in ("hv", "seeds", "neighbors")
                    if k in rec)
    print(f"phase 12 {tag}: {rec['evals']} evaluations in "
          f"{rec['wall_s']:.3f} s ({rec['evals_per_s']:.1f} evaluations/s)"
          f"{extra}, pareto_rank launches {rec['launches']['pareto_rank']}, "
          f"gp_cov launches {rec['launches']['gp_cov']}")


def tr_session(cache: Path, pkg: Package = CARD, chunk=None, **kw):
    """A session under the benchmark's NSGA and budget settings."""
    policy = dict(TR_POLICY_KW)
    if chunk is not None:
        policy["chunk_generations"] = chunk
    return pkg.Session(cache_dir=cache, nsga=pkg.NSGAConfig(**TR_NSGA_KW),
                       policy=pkg.BudgetPolicy(**policy), **kw)


def tr_problem(name: str, pkg: Package = CARD):
    return pkg.Problem(pkg.library()[name], TR_OBJ, ch_max=TR_CH_MAX,
                       space_kwargs=TR_SPACE_KW)


def transfer_arms(root: Path, key: int, budget: int = TR_BUDGET,
                  pkg: Package = CARD) -> tuple:
    """(a) and (b) of the reference benchmark at one key: every arm's
    record and each gate's readings, and the transfer arm's result."""
    arms = {}

    def arm(tag, session, name, b, transfer=True):
        r, rec = timed_submit(
            session, pkg.Query(tr_problem(name, pkg), budget=b,
                               transfer=transfer), pkg.sync,
            key=pkg.key(key))
        if r.provenance.from_cache:
            fail(f"phase 12 {tag} was served from cache")
        rec.update(graph=name, budget=b, transfer=transfer,
                   hv=float(r.trace.archive_hv[-1, 0]),
                   seeds=r.provenance.n_transfer_seeds,
                   neighbors=len(r.provenance.transferred_from))
        arms[tag] = rec
        print_arm(f"key {key} {tag}", rec)
        return r

    # (a) cold: an empty cache, the balanced_init seed, the full budget;
    # transfer: the neighbors cached first, half the budget
    cold = arm("cold", tr_session(root / "cold", pkg), TR_HELD_OUT, budget)
    if cold.provenance.transferred_from or cold.provenance.n_transfer_seeds < 1:
        fail(f"cold arm was not seeded by balanced_init: {cold.provenance}")
    svc = tr_session(root / "warm", pkg)
    for name in TR_NEIGHBORS:
        arm(f"neighbor {name}", svc, name, budget)
    warm = arm("transfer", svc, TR_HELD_OUT, budget // 2)
    gate = dict(hv_cold=arms["cold"]["hv"], hv_warm=arms["transfer"]["hv"],
                evals_frac=(warm.provenance.n_evals_run
                            / cold.provenance.n_evals_run),
                neighbors=list(warm.provenance.transferred_from))
    gate["hv_ratio"] = gate["hv_warm"] / gate["hv_cold"]
    gate["passes_alone"] = bool(gate["hv_ratio"] >= 1.0
                                and gate["evals_frac"] <= 0.60
                                and gate["neighbors"])
    if gate["evals_frac"] > 0.60 or not gate["neighbors"]:
        fail(f"transfer arm at key {key}: {gate}")

    # (b) a shallow run at B/8, cloned; unseeded against seeded refinement
    # at B (4-generation segments, a manifest bounded at 2 entries)
    arm("refine pre", tr_session(root / "refine_base", pkg, chunk=4),
        TR_HELD_OUT, budget // 8, transfer=False)
    for tag in ("refine_cold", "refine_warm"):
        shutil.copytree(root / "refine_base", root / tag)
    ref_cold = arm("refine unseeded",
                   tr_session(root / "refine_cold", pkg, chunk=4),
                   TR_HELD_OUT, budget, transfer=False)
    s_rw = tr_session(root / "refine_warm", pkg, chunk=4,
                      manifest_policy=pkg.ManifestPolicy(max_entries=2))
    for name in TR_NEIGHBORS:
        arm(f"refine neighbor {name}", s_rw, name, budget, transfer=False)
    ref_warm = arm("refine seeded", s_rw, TR_HELD_OUT, budget)
    manifest = s_rw.service.manifest
    probe = next(iter(manifest.entries.values()))["embedding"]
    if len(manifest) > 2 or not manifest.nearest(probe, k=8):
        fail(f"refine manifest: {len(manifest)} entries, nearest "
             f"{manifest.nearest(probe, k=8)}")
    hv_rc = arms["refine unseeded"]["hv"]
    rows = ref_warm.trace.archive_hv[:, 0]
    seg = ref_warm.provenance.n_evals_run // max(len(rows), 1)
    cross = next(((i + 1) * seg for i, v in enumerate(rows) if v >= hv_rc),
                 None)
    refine = dict(hv_unseeded=hv_rc, hv_seeded=arms["refine seeded"]["hv"],
                  seeded_trace=[float(v) for v in rows],
                  unseeded_evals=ref_cold.provenance.n_evals_run,
                  evals_per_segment=seg, evals_to_cross=cross,
                  neighbors=list(ref_warm.provenance.transferred_from),
                  manifest_entries=len(manifest))
    refine["hv_ratio"] = refine["hv_seeded"] / hv_rc
    refine["passes_alone"] = bool(
        cross is not None and refine["hv_ratio"] >= 1.0
        and cross <= 0.75 * refine["unseeded_evals"] and refine["neighbors"])
    if not refine["neighbors"]:
        fail(f"seeded refinement at key {key} took no neighbor: {refine}")
    print(f"phase 12 key {key}: transfer hv {gate['hv_warm']:.6f} against "
          f"cold {gate['hv_cold']:.6f} (ratio {gate['hv_ratio']:.4f}) at "
          f"{gate['evals_frac']:.2f} of its evaluations from "
          f"{len(gate['neighbors'])} neighbors (the reference's gate at "
          f"this key alone: {gate['passes_alone']}); seeded refinement "
          f"{refine['hv_seeded']:.6f} against {hv_rc:.6f} (ratio "
          f"{refine['hv_ratio']:.4f}), crossing at {cross} evaluations, "
          f"manifest {len(manifest)} entries (alone: "
          f"{refine['passes_alone']})")
    return dict(key=key, arms=arms, gate=gate, refine_gate=refine), warm


def pooled_gates(runs: list) -> tuple:
    """The benchmark's hypervolume conditions on ``transfer_arms`` readings
    pooled over their keys, with the count of keys meeting each gate alone
    held to ``TR_MIN_ALONE``: (transfer gate, refinement gate), each with
    its verdict under ``passes``."""
    keys = [v["key"] for v in runs]
    mean = lambda g, f: float(np.mean([v[g][f] for v in runs]))
    gate = dict(keys=keys, hv_cold_mean=mean("gate", "hv_cold"),
                hv_warm_mean=mean("gate", "hv_warm"),
                evals_frac_max=max(v["gate"]["evals_frac"] for v in runs),
                alone=[v["gate"]["passes_alone"] for v in runs])
    gate["hv_ratio"] = gate["hv_warm_mean"] / gate["hv_cold_mean"]
    gate["passes"] = bool(gate["hv_ratio"] >= 1.0
                          and sum(gate["alone"]) >= TR_MIN_ALONE)
    # (b) pooled: the key-mean seeded trace against the key-mean unseeded
    # final hypervolume, within 75% of the unseeded runs' evaluations
    n_seg = min(len(v["refine_gate"]["seeded_trace"]) for v in runs)
    trace = np.mean([v["refine_gate"]["seeded_trace"][:n_seg]
                     for v in runs], axis=0)
    seg = runs[0]["refine_gate"]["evals_per_segment"]
    target = mean("refine_gate", "hv_unseeded")
    cross = next(((i + 1) * seg for i, v in enumerate(trace)
                  if v >= target), None)
    unseeded = runs[0]["refine_gate"]["unseeded_evals"]
    refine = dict(keys=keys, hv_unseeded_mean=target,
                  hv_seeded_mean=mean("refine_gate", "hv_seeded"),
                  mean_seeded_trace=trace.tolist(), evals_to_cross=cross,
                  unseeded_evals=unseeded,
                  alone=[v["refine_gate"]["passes_alone"] for v in runs])
    refine["hv_ratio"] = refine["hv_seeded_mean"] / target
    refine["passes"] = bool(refine["hv_ratio"] >= 1.0 and cross is not None
                            and cross <= 0.75 * unseeded
                            and sum(refine["alone"]) >= TR_MIN_ALONE)
    return gate, refine


def transfer_gates(root: Path) -> tuple:
    """(a) and (b): the reference benchmark's two transfer gates at each of
    ``TR_KEYS`` — one process a key, all started together — held as
    ``pooled_gates`` holds them.  Returns (the readings, the front designs
    of the transfer arm at the reference's key)."""
    repo = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    procs = {key: subprocess.Popen(
        [sys.executable, "-c", TR_CHILD, repo, str(root / f"key{key}"),
         str(key)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for key in TR_KEYS}
    per_key = {}
    try:
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=TR_TIMEOUT_S)
            if proc.returncode != 0:
                fail(f"phase 12 key {key} exited {proc.returncode}: "
                     f"{err[-2000:]}")
            lines = out.strip().splitlines()
            print("\n".join(lines[:-1]))
            per_key[key] = json.loads(lines[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    print(f"phase 12 keys {list(TR_KEYS)}: {len(TR_KEYS)} processes at once "
          f"in {wall:.1f} s")
    fronts = {key: v.pop("front_designs") for key, v in per_key.items()}
    gate, refine = pooled_gates(list(per_key.values()))
    print(f"phase 12 transfer gate over keys {list(TR_KEYS)}: mean hv "
          f"{gate['hv_warm_mean']:.6f} against the cold runs' "
          f"{gate['hv_cold_mean']:.6f} (ratio {gate['hv_ratio']:.4f}, >= 1),"
          f" spend <= {gate['evals_frac_max']:.2f} of the cold run's "
          f"(<= 0.60); each key alone {gate['alone']} (>= {TR_MIN_ALONE} "
          f"true)")
    print(f"phase 12 refine gate over keys {list(TR_KEYS)}: the mean seeded "
          f"trace crosses the unseeded runs' mean final hv "
          f"{refine['hv_unseeded_mean']:.6f} at {refine['evals_to_cross']} "
          f"of {refine['unseeded_evals']} evaluations (<= 0.75), mean final "
          f"{refine['hv_seeded_mean']:.6f} (ratio {refine['hv_ratio']:.4f});"
          f" each key alone {refine['alone']} (>= {TR_MIN_ALONE} true)")
    if not gate["passes"]:
        fail(f"transfer gate: {gate}")
    if not refine["passes"]:
        fail(f"warm-refinement gate: {refine}")
    return (dict(per_key=per_key, gate=gate, refine_gate=refine,
                 keys_wall_s=wall), fronts[TR_KEYS[0]])


def resume_check(root: Path, problem, cold) -> dict:
    """(c) phase 5's default query stopped after its second segment, then
    resumed in a fresh session: bit-identical to phase 5's cold front."""
    query = Query(problem, budget=2048)
    ctl = RunControl()

    def stop_after_second(ev):
        if ev.segment == 1:
            ctl.stop()
    first, rec1 = timed_submit(Session(cache_dir=root / "resume",
                                       device="cuda"), query,
                               on_segment=stop_after_second, resume=True,
                               control=ctl)
    rest, rec2 = timed_submit(Session(cache_dir=root / "resume",
                                      device="cuda"), query, resume=True)
    again, rec3 = timed_submit(Session(cache_dir=root / "again",
                                       device="cuda"), query)

    def same(a, b):
        return (a.front_objs.tobytes() == b.front_objs.tobytes()
                and a.front_metrics.tobytes() == b.front_metrics.tobytes()
                and len(a.front_designs) == len(b.front_designs)
                and all(np.array_equal(x[k], y[k])
                        for x, y in zip(a.front_designs, b.front_designs)
                        for k in x))
    agree, resumed = same(again, cold), same(rest, cold)
    spent = first.provenance.n_evals_run + rest.provenance.n_evals_run
    for tag, rec in (("resume stopped", rec1), ("resume rest", rec2),
                     ("uninterrupted again", rec3)):
        print_arm(tag, rec)
    print(f"phase 12 resume: stopped after 2 segments (interrupted "
          f"{first.provenance.interrupted}), {first.provenance.n_evals_run}"
          f" + {rest.provenance.n_evals_run} = {spent} evaluations against "
          f"phase 5's {cold.provenance.n_evals_run}; resumed front "
          f"byte-identical to phase 5's: {resumed}; two uninterrupted runs "
          f"agree: {agree}")
    if not first.provenance.interrupted or rest.provenance.interrupted:
        fail("the stopped run was not interrupted, or the resumed one was")
    if spent != cold.provenance.n_evals_run:
        fail(f"resume spent {spent}, phase 5 {cold.provenance.n_evals_run}")
    if not (resumed and agree):
        fail(f"resume not bit-identical (resumed {resumed}, two "
             f"uninterrupted runs agree {agree})")
    return dict(stopped=rec1, rest=rec2, again=rec3, identical=resumed,
                uninterrupted_agree=agree)


def fleet_check(root: Path) -> dict:
    """(d) two processes write one cache directory at once; a third plans
    and runs a transfer query on what they left."""
    cache = root / "fleet"
    cache.mkdir(parents=True)
    repo = str(Path(__file__).resolve().parent)

    def child(name, mode):
        return subprocess.Popen(
            [sys.executable, "-c", FLEET_CHILD, repo, str(cache), name,
             mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def result(proc, tag):
        out, err = proc.communicate(timeout=FLEET_TIMEOUT_S)
        if proc.returncode != 0:
            fail(f"fleet {tag} exited {proc.returncode}: {err[-2000:]}")
        return json.loads(out.strip().splitlines()[-1])

    t0 = time.perf_counter()
    procs = [child(name, "write") for name in FLEET_WRITERS]
    try:
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while not all((cache / f".ready-{n}").exists()
                      for n in FLEET_WRITERS):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                fail("fleet writers did not get ready")
            time.sleep(0.01)
        (cache / ".go").touch()
        writers = [result(p, n) for p, n in zip(procs, FLEET_WRITERS)]
        keys = [w["key"] for w in writers]
        m = ArchiveManifest.load(cache / MANIFEST_NAME)
        lost = [k for k in keys if k not in m.entries]
        if len(set(keys)) != 2 or lost:
            fail(f"fleet manifest lost {lost} (keys {keys})")
        sizes = [len(ParetoArchive.load(cache / f"{k}.npz", device="cuda"))
                 for k in keys]
        if min(sizes) < 1:
            fail(f"fleet archives hold {sizes} rows")
        reader = result(child(FLEET_READER, "read"), FLEET_READER)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    planned = [k for k, _, quota in reader["plan"] if quota >= 1]
    print(f"phase 12 fleet: writers {[w['graph'] for w in writers]} "
          f"committed {keys} ({sizes} archive rows, manifest "
          f"{len(m)} entries); reader {FLEET_READER} planned "
          f"{reader['plan']} and ran seeded from "
          f"{reader['transferred_from']} in {time.perf_counter() - t0:.1f} s")
    for w in writers + [reader]:
        print_arm(f"fleet {w['graph']}", w)
    if not planned or reader["transferred_from"] != planned:
        fail(f"fleet reader planned {reader['plan']} but ran "
             f"{reader['transferred_from']}")
    return dict(writers=writers, reader=reader, archive_rows=sizes)


def tech_and_seeds(root: Path, front_designs) -> dict:
    """(e) a registered tech preset lands in an archive of its own; a
    ``bo_sa`` query seeded with designs migrated out of (a)'s front."""
    from repro_torch.core.presets import register_tech
    fast = dataclasses.replace(DEFAULT_TECH, router_delay_ns=10.0)
    register_tech(TECH_NAME, fast)
    s = tr_session(root / "tech")
    p = tr_problem(TR_HELD_OUT)
    r, rec = timed_submit(s, Query(p, budget=TECH_BUDGET, tech=TECH_NAME),
                          key=TR_KEY)
    label = f"{TECH_NAME}@{tech_key(fast)[:12]}"
    default_key = s.service.problem_key(p.spec, p.space)
    print_arm("tech preset", rec)
    print(f"phase 12 tech: {r.provenance.tech} under key "
          f"{r.provenance.cache_key} (default key {default_key})")
    if r.provenance.tech != label or r.provenance.cache_key == default_key:
        fail(f"tech preset query: {r.provenance}")
    # the same query again on an empty cache under the profiler: its
    # device time over the unprofiled wall above
    again = tr_session(root / "tech_profiled")
    device_s, n_kernels = device_by_kernel(lambda: again.submit(
        Query(p, budget=TECH_BUDGET, tech=TECH_NAME), key=TR_KEY))[:2]
    if device_s > 0:
        rec.update(device_s=device_s, kernels=n_kernels,
                   device_busy_share=device_s / rec["wall_s"])
        print(f"phase 12 tech: under the profiler device busy "
              f"{device_s * 1e3:.2f} ms = {rec['device_busy_share']:.1%} of "
              f"the unprofiled wall, {n_kernels} kernels")
    else:
        print("phase 12 tech: device busy share not measured (the profiler "
              "saw no device events)")

    qp = quickstart_problem()
    src = tr_problem(TR_HELD_OUT).space
    seeds = [migrate({k: np.asarray(v, np.int32) for k, v in d.items()},
                     src, qp.space)
             for d in front_designs[:QUICK_OPTS["n_init"]]]
    r2, rec2 = timed_submit(
        Session(cache_dir=root / "seeded", device="cuda"),
        Query(qp, engine="bo_sa", weights=OBJ_EDP, seed_designs=seeds,
              engine_opts=dict(QUICK_OPTS, sa=TWO_STAGE_SA)))
    pen = check_best(qp, r2)
    rec2.update(seeds=len(seeds), best_objective=r2.best_objective,
                best_penalty=pen)
    print_arm("seeded bo_sa", rec2)
    print(f"phase 12 seeded bo_sa: {len(seeds)} seeds migrated out of the "
          f"transfer arm's front, best objective {r2.best_objective:.6f}, "
          f"feasibility penalty {pen:.6g}")
    if rec2["launches"]["gp_cov"] != 2 * QUICK_OPTS["n_iter"]:
        fail(f"seeded bo_sa launched gp_cov {rec2['launches']['gp_cov']} "
             f"times")
    if abs(pen - 1.0) > 1e-6:
        fail(f"the seeded bo_sa best design is infeasible (penalty {pen})")
    return dict(tech=rec, tech_label=label, seeded_bo_sa=rec2)


def transfer_phase(problem, cold) -> dict:
    """Phase 12: (a)-(e) in one temporary directory."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        gates, front = transfer_gates(root)
        out = dict(gates, resume=resume_check(root, problem, cold),
                   fleet=fleet_check(root))
        out.update(tech_and_seeds(root, front))
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 12: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: megabatched and surrogate-gated search on the card
# ---------------------------------------------------------------------------
# (a) the reference's megabatch benchmark (benchmarks/bench_scale.py:76-103):
# four distinct BERT attention problems of one padded shape as lanes
MB_NAMES = ("att1", "att2", "att3", "att4")
MB_SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
MB_CH_MAX = 2
MB_POP, MB_GENS = 64, 8                 # the default query's pop, a segment
MB_LANES = (1, 4, 8)
MB_REPEAT = 3                           # min over repeats (200-500 ms runs)
MB_RATIO_GATE = 0.8                     # distinct >= 0.8 x same, 8 lanes
# the batched dominance count at the fused run's pools: selection and
# telemetry of 8 lanes at pop 64, three lanes of 768, lanes with NaN and
# +-inf, one lane (held against the single-pool entry too)
PARETO_LANE_SHAPES = ((8, 128, 2, "fused selection"),
                      (8, 64, 2, "fused telemetry"),
                      (3, 768, 4, "lanes of 768"),
                      (4, 200, 3, "nan/inf lanes"),
                      (1, 128, 2, "one lane"))
# (b) the reference's surrogate benchmark (benchmarks/bench_surrogate.py):
# train on the two attention neighbors of phase 12's space, search the
# held-out block exact at B and gated at 2B with a quarter exact
SUR_OPTS = dict(exact_frac=0.25, min_rows=16, epochs=300, beta=1.5, tau=0.5)
SUR_BUDGET = TR_BUDGET
SUR_HV_GATE = 0.99
SUR_SPEND_GATE = 0.50
# The benchmark holds the gated hypervolume at >= 0.99 x the exact arm's
# at one key.  On the CPU the reference itself meets that at 7 of 20 keys
# (keys 100-119 at B = 4096: per-key ratio mean 0.9763, sd 0.0254; pooled,
# mean gated over mean exact hypervolume, 0.9761; the port 4 of 20, mean
# 0.9710, sd 0.0228; ``tests/torch_surrogate_gates.py``), so one key is a
# draw the reference fails more often than not.  The card holds the pooled
# ratio to the reference's pooled ratio less two standard errors of a
# difference of two 20-key means (0.9761 - 2 x 0.0255 x sqrt(2 / 20) =
# 0.960), over the first 16 of those keys, two rounds of its 8 worker
# processes (on the H100 keys 100-115 read 0.9691, all 20 0.9686; with 16
# keys the same derivation would give 0.958, so the bound is kept).  The port's runs are deterministic
# (every card run reads the same hypervolumes), so the gate holds the code,
# not a draw.  Spend, accounting and no fallback are held at every key
SUR_KEYS = tuple(range(100, 116))
SUR_POOLED_HV = 0.960


def surrogate_arms(root: Path, key: int, budget: int = SUR_BUDGET,
                   pkg: Package = CARD) -> dict:
    """The surrogate benchmark's arms at one key: the exact arm (the
    held-out block on a fresh cache at B), the training arms (the two
    neighbors exact at B) and the gated arm (the held-out block at 2B,
    gated, its own key excluded from training).  Returns each arm's
    record and the gate's readings."""
    arms = {}

    def arm(tag, session, name, b, surrogate=None):
        q = pkg.Query(tr_problem(name, pkg), budget=b, engine_opts=(
            None if surrogate is None else {"surrogate": surrogate}))
        r, rec = timed_submit(session, q, pkg.sync, key=pkg.key(key))
        if r.provenance.from_cache:
            fail(f"phase 13 {tag} was served from cache")
        pv = r.provenance
        rec.update(graph=name, budget=b, hv=float(r.trace.archive_hv[-1, 0]),
                   surrogate_used=pv.surrogate_used,
                   hits=pv.surrogate_hits, fallbacks=pv.surrogate_fallbacks)
        arms[tag] = rec
        print(f"phase 13 key {key} {tag}: {rec['evals']} exact evaluations "
              f"in {rec['wall_s']:.3f} s, hv {rec['hv']:.6f}, surrogate "
              f"used {pv.surrogate_used}, hits {pv.surrogate_hits}, "
              f"fallbacks {pv.surrogate_fallbacks}, pareto_rank launches "
              f"{rec['launches']['pareto_rank']}")
        return r

    exact = arm("exact", tr_session(root / "exact", pkg), TR_HELD_OUT,
                budget)
    svc = tr_session(root / "gated", pkg)
    for name in TR_NEIGHBORS:
        arm(f"train {name}", svc, name, budget)
    held = svc.plan(pkg.Query(tr_problem(TR_HELD_OUT, pkg),
                              budget=budget)).cache_key
    gated = arm("gated", svc, TR_HELD_OUT, 2 * budget,
                surrogate=dict(SUR_OPTS, exclude=[held]))
    sched = quantize.schedule(2 * budget, TR_NSGA_KW["pop"],
                              BudgetPolicy().chunk_generations)
    total = sched.pop * sched.chunk * sched.n_seg
    pv = gated.provenance
    gate = dict(key=key, hv_exact=arms["exact"]["hv"],
                hv_gated=arms["gated"]["hv"],
                evals_exact=exact.provenance.n_evals_run,
                evals_gated=pv.n_evals_run, hits=pv.surrogate_hits,
                fallbacks=pv.surrogate_fallbacks, used=pv.surrogate_used,
                schedule=total)
    gate["hv_ratio"] = gate["hv_gated"] / max(gate["hv_exact"], 1e-12)
    gate["evals_frac"] = gate["evals_gated"] / max(gate["evals_exact"], 1)
    gate["accounted"] = gate["evals_gated"] + gate["hits"] == total
    gate["passes_alone"] = bool(gate["hv_ratio"] >= SUR_HV_GATE
                                and gate["evals_frac"] <= SUR_SPEND_GATE
                                and gate["accounted"] and gate["used"])
    return dict(key=key, arms=arms, gate=gate)


def pooled_surrogate_gate(runs: list) -> dict:
    """The surrogate benchmark's gates on ``surrogate_arms`` readings
    pooled over their keys: at every key the gate was used, never fell
    back, spent <= ``SUR_SPEND_GATE`` of the exact arm's evaluations and
    accounted for every skipped candidate; over the keys, the mean gated
    hypervolume is at least ``SUR_POOLED_HV`` times the mean exact one."""
    g = [v["gate"] for v in runs]
    out = dict(keys=[v["key"] for v in runs],
               hv_exact_mean=float(np.mean([x["hv_exact"] for x in g])),
               hv_gated_mean=float(np.mean([x["hv_gated"] for x in g])),
               evals_frac_max=max(x["evals_frac"] for x in g),
               accounted=all(x["accounted"] for x in g),
               used=all(x["used"] for x in g),
               fallbacks=sum(x["fallbacks"] for x in g),
               alone=[x["passes_alone"] for x in g])
    out["hv_ratio"] = out["hv_gated_mean"] / out["hv_exact_mean"]
    out["passes"] = bool(out["hv_ratio"] >= SUR_POOLED_HV
                         and out["evals_frac_max"] <= SUR_SPEND_GATE
                         and out["accounted"] and out["used"]
                         and out["fallbacks"] == 0)
    return out


SUR_CHILD = r"""
import json, sys
from pathlib import Path
repo, root, keys = sys.argv[1:4]
sys.path.insert(0, repo)
import chip_smoke
chip_smoke.torch.set_num_threads(1)    # the workers share the host's cores
for key in keys.split(","):
    print(json.dumps(chip_smoke.surrogate_arms(Path(root) / key, int(key))),
          flush=True)
"""
SUR_WORKERS = 8                        # one a host core


def surrogate_phase(root: Path) -> dict:
    """(b): the surrogate benchmark at each of ``SUR_KEYS`` — the keys dealt
    round-robin to ``SUR_WORKERS`` processes started together — held as
    ``pooled_surrogate_gate`` holds them; then the identity arm: gating
    asked for on an empty cache runs the exact path bit for bit."""
    repo = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    deal = [SUR_KEYS[i::SUR_WORKERS] for i in range(SUR_WORKERS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SUR_CHILD, repo, str(root),
         ",".join(map(str, keys))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for keys in deal if keys]
    per_key = {}
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TR_TIMEOUT_S)
            if proc.returncode != 0:
                fail(f"phase 13 worker exited {proc.returncode}: "
                     f"{err[-2000:]}")
            for line in out.strip().splitlines():
                if line.startswith("{"):
                    v = json.loads(line)
                    per_key[v["key"]] = v
                else:
                    print(line)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if sorted(per_key) != sorted(SUR_KEYS):
        fail(f"phase 13 surrogate keys read {sorted(per_key)}")
    per_key = {k: per_key[k] for k in SUR_KEYS}
    wall = time.perf_counter() - t0
    gate = pooled_surrogate_gate(list(per_key.values()))
    for key, v in per_key.items():
        x = v["gate"]
        print(f"phase 13 surrogate key {key}: gated hv {x['hv_gated']:.6f} "
              f"against exact {x['hv_exact']:.6f} (ratio "
              f"{x['hv_ratio']:.4f}), exact spend {x['evals_frac']:.3f} of "
              f"the exact arm's, {x['evals_gated']} + {x['hits']} hits of a "
              f"{x['schedule']} schedule, fallbacks {x['fallbacks']} (the "
              f"reference's gate at this key alone: {x['passes_alone']})")
    print(f"phase 13 surrogate gate over keys {SUR_KEYS[0]}-{SUR_KEYS[-1]} "
          f"({len(procs)} processes at once, {wall:.1f} s): mean gated hv "
          f"{gate['hv_gated_mean']:.6f} against exact "
          f"{gate['hv_exact_mean']:.6f} (ratio {gate['hv_ratio']:.4f}, >= "
          f"{SUR_POOLED_HV}), spend <= {gate['evals_frac_max']:.3f} (<= "
          f"{SUR_SPEND_GATE}), accounted {gate['accounted']}, fallbacks "
          f"{gate['fallbacks']}; each key alone at 0.99 {gate['alone']}")
    if not gate["passes"]:
        fail(f"surrogate gate: {gate}")
    # identity: gating on an EMPTY cache is the exact path, bit for bit
    small = SUR_BUDGET // 4
    ra, rec_a = timed_submit(
        tr_session(root / "ident_a"),
        Query(tr_problem(TR_HELD_OUT), budget=small,
              engine_opts={"surrogate": dict(SUR_OPTS)}), key=SUR_KEYS[0])
    rb, _ = timed_submit(tr_session(root / "ident_b"),
                         Query(tr_problem(TR_HELD_OUT), budget=small),
                         key=SUR_KEYS[0])
    ident = (not ra.provenance.surrogate_used
             and ra.provenance.n_evals_run == rb.provenance.n_evals_run
             and ra.front_objs.tobytes() == rb.front_objs.tobytes()
             and ra.front_metrics.tobytes() == rb.front_metrics.tobytes())
    print(f"phase 13 surrogate identity: gating on an empty cache at "
          f"{small} evaluations is the exact path bit for bit: {ident}")
    if not ident:
        fail("a gated query on an empty cache diverged from the exact path")
    return dict(per_key=per_key, gate=gate, keys_wall_s=wall,
                identity=dict(bit_identical=ident, **rec_a))


def mb_problems() -> list:
    """The megabatch benchmark's problems: (spec, space) of each of
    ``MB_NAMES`` (one padded shape)."""
    out = []
    for name in MB_NAMES:
        spec = SystemSpec.build(presets.bert_mms()[name], ch_max=MB_CH_MAX)
        out.append((spec, DesignSpace(spec, **MB_SPACE_KW)))
    return out


def check_pareto_lanes() -> list:
    """The batched dominance count against its plain version, exactly, at
    the fused run's pools, one launch a call and lane for lane equal to
    the single-pool entry; timed beside the L single-pool launches of the
    same lanes, L times one pool's bound and the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for L, n, k, tag in PARETO_LANE_SHAPES:
        pools = [pareto_pool(n, k, 0.9, tag, gen) for _ in range(L)]
        objs = torch.stack([o for o, _ in pools])
        valid = torch.stack([v for _, v in pools])
        before = pareto_ops.dominance_counts.launches
        got = pareto_ops.dominance_counts(objs, valid)
        torch.cuda.synchronize()
        if pareto_ops.dominance_counts.launches - before != 1:
            fail(f"pareto_rank {L} lanes of ({n}, {k}) took "
                 f"{pareto_ops.dominance_counts.launches - before} launches")
        want = dominance_counts_ref(objs, valid)
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            fail(f"pareto_rank lanes disagree with the plain version at "
                 f"({L}, {n}, {k}): max abs err {err}")
        singles = torch.stack([pareto_ops.dominance_counts(objs[i], valid[i])
                               for i in range(L)])
        if not torch.equal(singles, got):
            fail(f"pareto_rank lanes differ from single-pool launches at "
                 f"({L}, {n}, {k})")
        call = lambda: pareto_ops.dominance_counts(objs, valid)
        one_by_one = lambda: [pareto_ops.dominance_counts(objs[i], valid[i])
                              for i in range(L)]
        k_ms = cuda_ms(call, 200)
        s_ms = cuda_ms(one_by_one, 200)
        dev_ms = device_ms_per_launch(call, "rank_kernel")
        # the device time of L single launches at the selection's pools
        dev_one = (device_ms_per_launch(one_by_one, "rank_kernel")
                   if tag == "fused selection" else None)
        p_ms = cuda_ms(lambda: dominance_counts_ref(objs, valid), 20)
        b_one, b_by = pareto_bound_ms(n, k)
        rows.append(dict(lanes=L, n=n, k=k, tag=tag, exact=True,
                         max_abs_err=err, ms=k_ms, device_ms=dev_ms,
                         singles_ms=s_ms,
                         singles_device_ms=(None if dev_one is None
                                            else dev_one * L),
                         plain_ms=p_ms, bound_ms=L * b_one, bound_by=b_by))
        dev = ("not measured" if dev_ms is None else f"{dev_ms * 1e3:.3f} us"
               + ("" if dev_one is None else
                  f", {L} single launches {dev_one * L * 1e3:.3f} us"))
        print(f"pareto_rank lanes ({L}, {n}, {k}) {tag}: exact, one launch,"
              f" wrapper {k_ms * 1e3:.2f} us per call ({L} single calls "
              f"{s_ms * 1e3:.2f} us), device {dev}, plain "
              f"{p_ms * 1e3:.2f} us, bound {L * b_one * 1e3:.4f} us "
              f"({b_by})")
    return rows


def fused_lanes_check(problems) -> dict:
    """``make_nsga_fused`` over the distinct problems against each lane's
    unbatched ``make_nsga`` run on the card: designs bit-identical, raw
    metrics within rtol 1e-6."""
    spec0, space0 = problems[0]
    cfg = NSGAConfig(pop=MB_POP, generations=MB_GENS)
    seeds = list(range(1, len(problems) + 1))
    pops = [random_design(30 + i, sp, n=MB_POP, device="cuda")
            for i, (_, sp) in enumerate(problems)]
    fused = make_nsga_fused(spec0, space0, TR_OBJ, cfg, lanes=len(problems),
                            device="cuda")(
        seeds, {k: torch.stack([p[k] for p in pops]) for k in pops[0]},
        [spec.arrays for spec, _ in problems])
    worst = 0.0
    for j, (spec, _) in enumerate(problems):
        single = make_nsga(spec0, space0, TR_OBJ, cfg, device="cuda")(
            seeds[j], pops[j], arrays=spec.arrays)
        same = (all(torch.equal(single[0][k], fused[0][k][j])
                    for k in single[0])
                and all(torch.equal(single[3][k], fused[3][k][j])
                        for k in single[3]))
        if not same:
            fail(f"fused lane {j} ({MB_NAMES[j]}) evolved other designs "
                 f"than its unbatched run")
        for a, b in ((fused[1][j], single[1]), (fused[4][j], single[4])):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-6, err_msg=f"lane {j} raw")
            worst = max(worst, float(((a - b).abs() / b.abs().clamp_min(
                1e-30)).max()))
    print(f"phase 13 fused lanes: {len(problems)} distinct problems "
          f"({', '.join(MB_NAMES)}) at pop {MB_POP} x {MB_GENS} generations"
          f", each lane's designs bit-identical to its unbatched run, raw "
          f"metrics max rel diff {worst:.3g} (<= 1e-6)")
    return dict(lanes=len(problems), designs_identical=True,
                raw_max_rel=worst)


def megabatch_throughput(problems) -> dict:
    """bench_scale's megabatch arm on the card: fused runs of L lanes of
    distinct problems against L lanes of the same problem (min wall of
    ``MB_REPEAT`` runs each, the two interleaved), against L sequential
    ``make_nsga`` runs, with the
    kernels and ``pareto_rank`` launches a generation and the device busy
    share of the distinct run."""
    spec0, space0 = problems[0]
    cfg = NSGAConfig(pop=MB_POP, generations=MB_GENS)
    out = {}
    for L in MB_LANES:
        probs = [problems[i % len(problems)] for i in range(L)]
        run = make_nsga_fused(spec0, space0, TR_OBJ, cfg, lanes=L,
                              device="cuda")
        pops = [random_design(100 + i, space0, n=MB_POP, device="cuda")
                for i in range(L)]
        stack = {k: torch.stack([p[k] for p in pops]) for k in pops[0]}
        seeds = list(range(L))
        distinct = [spec.arrays for spec, _ in probs]

        def best_of(fn, repeat=MB_REPEAT, warm=True):
            if warm:
                fn()
                torch.cuda.synchronize()
            best = float("inf")
            for _ in range(repeat):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            return best
        # the two arms interleaved (ABBA): the host's drift hits both
        arms = {"same": [spec0.arrays] * L, "distinct": distinct}
        for arrays in arms.values():                    # warm-up
            run(seeds, stack, arrays)
        walls = {arm: [] for arm in arms}
        for i in range(MB_REPEAT):
            for arm in (("same", "distinct") if i % 2 == 0
                        else ("distinct", "same")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(seeds, stack, arms[arm])
                torch.cuda.synchronize()
                walls[arm].append(time.perf_counter() - t0)
        t_same, t_dist = min(walls["same"]), min(walls["distinct"])
        singles = [make_nsga(spec0, space0, TR_OBJ, cfg, device="cuda")
                   for _ in range(L)]
        t_seq = best_of(lambda: [singles[i](seeds[i], pops[i],
                                            arrays=distinct[i])
                                 for i in range(L)], repeat=1, warm=False)
        before = launch_counts()["pareto_rank"]
        run(seeds, stack, distinct)
        torch.cuda.synchronize()
        pr = (launch_counts()["pareto_rank"] - before) / MB_GENS
        dev_s, n_k = device_by_kernel(lambda: run(seeds, stack, distinct),
                                      host=False)[:2]
        evals = L * MB_POP * MB_GENS
        rec = dict(lanes=L, evals=evals, same_s=t_same, distinct_s=t_dist,
                   sequential_s=t_seq, evals_per_s=evals / t_dist,
                   same_evals_per_s=evals / t_same,
                   sequential_evals_per_s=evals / t_seq,
                   ratio=t_same / t_dist,
                   pareto_rank_per_generation=pr)
        if dev_s > 0:
            rec.update(kernels_per_generation=n_k / MB_GENS,
                       device_s=dev_s, device_busy_share=dev_s / t_dist)
        out[L] = rec
        dev = ("device not measured" if dev_s <= 0 else
               f"{rec['kernels_per_generation']:.0f} kernels a generation, "
               f"device busy {rec['device_busy_share']:.1%}")
        print(f"phase 13 megabatch L={L}: distinct {evals / t_dist:.1f} "
              f"evaluations/s ({t_dist * 1e3:.1f} ms), same problem "
              f"{evals / t_same:.1f} (ratio {rec['ratio']:.3f}), "
              f"sequential {evals / t_seq:.1f} ({t_seq * 1e3:.1f} ms); "
              f"{pr:.0f} pareto_rank launches a generation; {dev}")
    ratio = out[max(MB_LANES)]["ratio"]
    if ratio < MB_RATIO_GATE:
        fail(f"megabatched distinct problems reached {ratio:.3f} x the "
             f"same-problem fused throughput at {max(MB_LANES)} lanes "
             f"(gate >= {MB_RATIO_GATE})")
    return out


def megabatch_submit() -> dict:
    """One ``Session.submit`` of the distinct problems at the default query
    (budget 2048, pop 64), fused (``BudgetPolicy()``) against
    ``megabatch=False``: the same fronts (designs bit-identical, metrics
    rtol 1e-6, spend equal).  The fused submission is this phase's main
    path: the kernel counts are set to 0 just before it and read just
    after."""
    def queries():
        return [Query(Problem(presets.bert_mms()[n], TR_OBJ,
                              ch_max=MB_CH_MAX, space_kwargs=MB_SPACE_KW),
                      budget=2048) for n in MB_NAMES]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, policy in (("fused", BudgetPolicy()),
                            ("sequential", BudgetPolicy(megabatch=False))):
            s = Session(cache_dir=Path(tmp) / tag, policy=policy,
                        device="cuda")
            pareto_ops.dominance_counts.launches = 0
            pareto_ops.dominance_counts.launches_lanes = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = s.submit(queries(), key=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = sum(r.provenance.n_evals_run for r in rs)
            out[tag] = dict(wall_s=wall, evals=n, evals_per_s=n / wall,
                            launches=pareto_ops.dominance_counts.launches,
                            launches_lanes=pareto_ops.dominance_counts
                            .launches_lanes, results=rs)
            print(f"phase 13 submit {tag}: {len(rs)} problems, {n} "
                  f"evaluations in {wall:.3f} s ({n / wall:.1f} "
                  f"evaluations/s), pareto_rank launches "
                  f"{out[tag]['launches']} ({out[tag]['launches_lanes']} "
                  f"of several lanes)")
    fused, seq = out["fused"].pop("results"), out["sequential"].pop("results")
    if out["fused"]["launches_lanes"] == 0:
        fail("the fused submission launched no batched pareto_rank")
    for rf, rq in zip(fused, seq):
        if (rf.provenance.n_evals_run != rq.provenance.n_evals_run
                or len(rf.front_designs) != len(rq.front_designs)
                or not all(np.array_equal(a[k], b[k])
                           for a, b in zip(rf.front_designs,
                                           rq.front_designs) for k in a)):
            fail(f"fused front of {rf.provenance.cache_key} differs from "
                 f"its sequential front")
        np.testing.assert_allclose(rf.front_metrics, rq.front_metrics,
                                   rtol=1e-6)
    print(f"phase 13 submit: fused fronts equal the sequential fronts "
          f"(designs bit-identical, metrics rtol 1e-6, spend equal)")
    return out


def megabatch_phase() -> dict:
    """Phase 13: (a) megabatching — the batched kernel, the fused lanes
    against their unbatched runs, bench_scale's throughput gate and the
    fused submission against the sequential one — then (b) the surrogate
    benchmark."""
    t0 = time.perf_counter()
    problems = mb_problems()
    out, walls = {}, {}
    for part, fn in (("lane_shapes", check_pareto_lanes),
                     ("fused_lanes", lambda: fused_lanes_check(problems)),
                     ("throughput", lambda: megabatch_throughput(problems)),
                     ("submit", megabatch_submit)):
        t1 = time.perf_counter()
        out[part] = fn()
        walls[part] = time.perf_counter() - t1
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out["surrogate"] = surrogate_phase(Path(tmp))
    walls["surrogate"] = time.perf_counter() - t1
    out.update(wall_s=time.perf_counter() - t0, part_walls_s=walls)
    print(f"phase 13: {out['wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# ---- 14. calibration and the flight recorder ------------------------------
VAL_SHAPES = SWEEP_SHAPES                 # bench_validation's SHAPES
VAL_FIT_SHAPES, VAL_HELD_SHAPES = VAL_SHAPES[:6], VAL_SHAPES[6:]
VAL_BWS = (128.0, 16.0)
VAL_FREE = ("t_tile_overhead_ns", "corr_latency")
VAL_PAPER_BOUND = 0.098                  # the paper's Sec. V-A bound
VAL_IMPROVEMENT = 0.5
CALIB_STEPS = 100                         # the default's 400, cut
CALIB_REPEAT_STEPS = 40                   # the two fits held to one digest
CALIB_RTOL = 1e-3                         # card fit against the CPU fit
JAC_RTOL = 1e-4                           # card jacobian against the CPU
# bench_obs gates the minimum over 5 interleaved (off, on) pairs.  On the
# card's host a submission's wall varies by 13-15% (sd) between identical
# runs, and a rare fast run decides a minimum or moves a median: two
# DISABLED arms over 25 pairs read minima 29 ms and medians 46 ms apart
# (PERF.md, section 6).  Phase 14 holds the same bound on the paired
# differences: the mean of each pair's journaled - disabled wall, 10%
# trimmed at each end, in a fresh process.  Whole submissions run back to
# back differ by ~110 ms (sd) and drift together only weakly, so the two
# arms of a pair run in lockstep, taking turns at each segment boundary
# (``obs_pair``).  The pairs run until the mean plus two standard errors
# is below the gate, at least OBS_MIN_PAIRS and at most OBS_PAIRS of them
# (the gate itself holds the mean): a fast host's pair differences vary
# by ~35-40 ms (sd), so it stops at about 16 pairs; a slow host's by ~120
# ms, where 40 pairs put two standard errors at about 42 ms
OBS_MIN_PAIRS = 16
OBS_PAIRS = 40
OBS_TRIM = 0.1
OBS_TIMEOUT_S = 600
OBS_GATE_REL, OBS_GATE_ABS = 1.03, 0.05   # bench_obs's overhead gate
CALIB_NAME = "smoke_calibrated"


def fit_walls(ms, device: str, steps: int = CALIB_STEPS) -> tuple:
    """``fit`` of ``ms`` under ``DEFAULT_FREE`` at ``steps`` on
    ``device``, with its synchronized wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(ms, steps=steps, device=device)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def calib_fit_check(ms) -> dict:
    """(a): the default calibration on the card, against the CPU's fit of
    the same rows; two shorter card fits held to one digest; ms and
    launches per Adam step and the device busy share from a profiled
    short fit."""
    card, card_s = fit_walls(ms, "cuda")
    cpu, cpu_s = fit_walls(ms, "cpu")
    short, _ = fit_walls(ms, "cuda", CALIB_REPEAT_STEPS)
    again, _ = fit_walls(ms, "cuda", CALIB_REPEAT_STEPS)
    if short.digest != again.digest:
        fail(f"two card fits differ: {short.fitted} vs {again.fitted}")
    worst = max(abs(card.fitted[f] / cpu.fitted[f] - 1.0)
                for f in DEFAULT_FREE)
    if worst > CALIB_RTOL:
        fail(f"card fit {card.fitted} vs CPU fit {cpu.fitted}: rel "
             f"{worst:.3g} > {CALIB_RTOL}")
    # per step: the difference of two fits that differ only in their steps
    # (the predictors' build and the before/after predictions cancel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(ms, steps=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step_ms = (card_s - setup_s) / CALIB_STEPS * 1e3
    d_long = device_by_kernel(lambda: fit(ms, steps=6, device="cuda"),
                              host=False)
    d_short = device_by_kernel(lambda: fit(ms, steps=2, device="cuda"),
                               host=False)
    out = dict(rows=len(ms), steps=CALIB_STEPS, card_wall_s=card_s,
               cpu_wall_s=cpu_s, setup_s=setup_s, ms_per_step=step_ms,
               fitted=card.fitted, cpu_fitted=cpu.fitted,
               max_rel_vs_cpu=worst, digest=card.digest,
               loss=list(card.loss), errors=card.errors)
    if d_long[0] > 0 and d_short[0] > 0:
        dev_ms = (d_long[0] - d_short[0]) / 4 * 1e3
        out.update(launches_per_step=(d_long[1] - d_short[1]) / 4,
                   device_ms_per_step=dev_ms,
                   device_busy_share=dev_ms / step_ms)
        busy = (f"{out['launches_per_step']:.0f} launches and "
                f"{dev_ms:.3f} ms of device time a step (device busy "
                f"{out['device_busy_share']:.1%})")
    else:
        busy = "launches and device time a step not measured (the " \
               "profiler saw no device events)"
    print(f"phase 14 (a) fit: {len(ms)} rows x {CALIB_STEPS} Adam steps "
          f"on the card in {card_s:.2f} s ({step_ms:.2f} ms a step after "
          f"{setup_s:.2f} s of set-up; the CPU took {cpu_s:.2f} s); {busy}; "
          f"fitted {card.fitted}; max rel vs the CPU {worst:.3g} (<= "
          f"{CALIB_RTOL}); two card fits of {CALIB_REPEAT_STEPS} steps, one "
          f"digest {short.digest[:12]}")
    return out


def validation_arm() -> tuple:
    """(b): bench_validation's calibration arm at its full budget on the
    card; held-out mean latency error <= min(0.5 x uncalibrated, 9.8%)."""
    train = simulator_sweep(shapes=VAL_FIT_SHAPES, bws=VAL_BWS)
    held = simulator_sweep(shapes=VAL_HELD_SHAPES, bws=VAL_BWS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(train, free=VAL_FREE, holdout=held, steps=CALIB_STEPS,
              lr=0.05, seed=0, device="cuda")
    wall = time.perf_counter() - t0
    before = res.errors["holdout_before"]["mean"]
    after = res.errors["holdout_after"]["mean"]
    bound = min(VAL_IMPROVEMENT * before, VAL_PAPER_BOUND)
    print(f"phase 14 (b) bench_validation arm: held-out error "
          f"{after:.4%} (uncalibrated {before:.4%}, gate <= {bound:.4%}); "
          f"t_tile_overhead_ns {res.fitted['t_tile_overhead_ns']:.4f} "
          f"corr_latency {res.fitted['corr_latency']:.6f}; {wall:.2f} s")
    if not after <= bound:
        fail(f"calibration gate: held-out {after:.4%} > {bound:.4%}")
    return res, dict(holdout_before=before, holdout_after=after,
                     gate=bound, fitted=res.fitted, wall_s=wall)


def calib_jacobian(spec, design, base) -> np.ndarray:
    """(4, 25): d metrics / d fittable fields of one design at ``base``,
    by reverse-mode autograd on the design's device."""
    dev = design["shape"].device

    def metrics_of(vals):
        tech = dataclasses.replace(base, **dict(zip(FITTABLE_FIELDS, vals)))
        out = evaluate_system(spec, design, tech=tech)
        return torch.stack([out[k][0] for k in METRIC_KEYS])

    v0 = torch.tensor([float(getattr(base, f)) for f in FITTABLE_FIELDS],
                      dtype=torch.float32, device=dev)
    return torch.autograd.functional.jacobian(metrics_of, v0).cpu().numpy()


def jacobian_check() -> dict:
    """(c): the jacobian on the golden design on the card: finite, every
    ``METRIC_FIELDS`` entry non-zero, ``core_buf_bw`` non-zero when the
    buffers starve, and the CPU's within rtol 1e-4."""
    spec = SystemSpec.build(presets.transformer_block(), ch_max=2)
    design = golden_design(spec)
    cpu_design = {k: v.cpu() for k, v in design.items()}
    d = DEFAULT_TECH
    golden = dataclasses.replace(d, t_tile_overhead_ns=8.0)
    starved = dataclasses.replace(
        golden, dram_bw=d.dram_bw * 0.01, core_buf_bw=d.core_buf_bw * 0.01,
        chip_buf_bw=d.chip_buf_bw * 0.01, chip_noc_bw=d.chip_noc_bw * 0.01)
    out = {}
    for tag, base in (("golden", golden), ("starved", starved)):
        J = calib_jacobian(spec, design, base)
        Jc = calib_jacobian(spec, cpu_design, base)
        if not np.isfinite(J).all():
            fail(f"non-finite jacobian entry ({tag})")
        np.testing.assert_allclose(J, Jc, rtol=JAC_RTOL, atol=0,
                                   err_msg=f"card vs CPU jacobian ({tag})")
        if tag == "golden":
            for metric, fields in METRIC_FIELDS.items():
                for f in fields:
                    if J[METRIC_KEYS.index(metric),
                         FITTABLE_FIELDS.index(f)] == 0.0:
                        fail(f"d {metric} / d {f} vanished on the card")
        else:
            g = J[METRIC_KEYS.index("latency_ns"),
                  FITTABLE_FIELDS.index("core_buf_bw")]
            if g == 0.0:
                fail("d latency / d core_buf_bw stayed 0 under starvation")
        rel = float(np.max(np.abs(J - Jc) / np.maximum(np.abs(Jc), 1e-30)))
        out[tag] = dict(nonzero=int(np.count_nonzero(J)),
                        max_rel_vs_cpu=rel)
    print(f"phase 14 (c) jacobian 4 x {len(FITTABLE_FIELDS)}: finite, every "
          f"METRIC_FIELDS entry non-zero, core_buf_bw non-zero when "
          f"starved; card vs CPU max rel {out['golden']['max_rel_vs_cpu']:.3g}"
          f" / {out['starved']['max_rel_vs_cpu']:.3g} (<= {JAC_RTOL})")
    return out


def obs_submit(problem, cache: Path, journal) -> tuple:
    """One cold submission of ``problem`` at budget 2048 into a fresh
    archive directory: (result, wall seconds)."""
    if cache.exists():
        shutil.rmtree(cache)
    s = Session(cache_dir=cache, journal=journal, device="cuda",
                policy=BudgetPolicy(adaptive=False, reallocate=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = s.submit(Query(problem, budget=2048))
    return r, time.perf_counter() - t0


def main_problem():
    """Phase 5's problem: the Fig. 4a transformer block, latency and cost,
    ``ch_max=4`` (its query is budget 2048 at the default NSGA)."""
    return Problem(presets.transformer_block(), ("latency_ns", "cost_usd"),
                   ch_max=4)


def obs_pair(problem, root: Path, i: int, journaled: bool) -> dict:
    """One (disabled, journaled) pair of phase 5's query in lockstep: the
    two cold submissions run in two threads that take turns at every
    segment boundary, so the arms' segments alternate ~0.2 s apart and
    share the host's drift (a whole submission apart, the walls correlate
    only 0.4).  The recorder is on only while the journaled arm holds the
    turn; ``journaled=False`` runs the disabled arm on both sides.  Arm
    ``i % 2`` goes first.  Returns ``{arm: (result, busy seconds)}``: a
    submission's wall less the time its thread waited for the turn."""
    cv = threading.Condition()
    state = dict(holder=bool(i % 2), done=set())
    out, errs = {}, []
    jp = root / f"journal_{i}.jsonl"

    def take(arm: bool) -> float:
        t0 = time.perf_counter()
        with cv:
            cv.wait_for(lambda: state["holder"] == arm
                        or (not arm) in state["done"])
            state["holder"] = arm
        if arm and journaled:
            obs.enable()
        else:
            obs.disable()
        return time.perf_counter() - t0

    def give(arm: bool, done: bool = False) -> None:
        with cv:
            if done:
                state["done"].add(arm)
            state["holder"] = not arm
            cv.notify_all()

    def body(arm: bool) -> None:
        waited = [0.0]

        def on_segment(ev):
            give(arm)
            waited[0] += take(arm)
        try:
            take(arm)
            cache = root / f"cache_{int(arm)}"
            if cache.exists():
                shutil.rmtree(cache)
            s = Session(cache_dir=cache, journal=jp if arm and journaled
                        else False, device="cuda",
                        policy=BudgetPolicy(adaptive=False,
                                            reallocate=False))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = s.submit(Query(problem, budget=2048), on_segment=on_segment)
            out[arm] = (r, time.perf_counter() - t0 - waited[0])
        except BaseException as e:     # re-raised by the caller
            errs.append(e)
        finally:
            give(arm, done=True)

    threads = [threading.Thread(target=body, args=(arm,))
               for arm in (False, True)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        obs.enable()
    if errs:
        raise errs[0]
    return out


def obs_overhead(on, off) -> dict:
    """The journaled arm's extra wall over its disabled pair: the
    ``OBS_TRIM``-trimmed mean of the pairs' differences, its standard
    error, the disabled median and the gate, max(3%, 50 ms)."""
    t_off = float(np.median(off))
    diffs = np.sort(np.asarray(on) - np.asarray(off))     # pair by pair
    k = int(len(diffs) * OBS_TRIM)
    kept = diffs[k:len(diffs) - k]
    return dict(extra=float(kept.mean()),
                se=float(kept.std(ddof=1) / np.sqrt(len(kept))),
                t_off=t_off,
                gate=max((OBS_GATE_REL - 1.0) * t_off, OBS_GATE_ABS))


def obs_arms(root: Path, pairs: int, placebo: bool = False) -> dict:
    """bench_obs's arms on phase 5's query, in this process: up to
    ``pairs`` lockstep (disabled, journaled) pairs (``obs_pair``), ending
    early from ``OBS_MIN_PAIRS`` on once the overhead's mean plus two
    standard errors is below its gate, a collected heap before each pair,
    fresh archives; every front, the last journaled run's journal replayed
    and rendered.  ``placebo`` runs the disabled arm on both sides (the
    yardstick of the host's noise) for all ``pairs``."""
    problem = main_problem()
    pareto_ops.build()
    obs_submit(problem, root / "warmup", False)
    obs_submit(problem, root / "warmup_j", root / "warmup.jsonl")
    walls = {False: [], True: []}
    fronts, r_on, jp = set(), None, None
    pareto_ops.dominance_counts.launches = 0
    for i in range(pairs):
        gc.collect()
        pair = obs_pair(problem, root, i, journaled=not placebo)
        for on, (r, wall) in pair.items():
            walls[on].append(wall)
            fronts.add(r.front_metrics.tobytes() + r.front_objs.tobytes())
        r_on, jp = pair[True][0], root / f"journal_{i}.jsonl"
        if not placebo and i + 1 >= OBS_MIN_PAIRS:
            o = obs_overhead(walls[True], walls[False])
            if o["extra"] + 2.0 * o["se"] < o["gate"]:
                break
    out = dict(walls_on_s=walls[True], walls_off_s=walls[False],
               identical=len(fronts) == 1,
               launches=pareto_ops.dominance_counts.launches)
    if placebo:
        return out
    records = list(obs.read_journal(jp))
    rp = obs.replay(records).get(r_on.provenance.cache_key, {})
    hv = float(r_on.trace.archive_hv[-1, 0])
    out["replay"] = (rp.get("segments") == r_on.trace.archive_hv.shape[0]
                     and rp.get("n_evals") == r_on.provenance.n_evals_run
                     and rp.get("final_hv") is not None
                     and abs(rp["final_hv"] - hv) <= 1e-9 * max(abs(hv), 1.0))
    out["replayed"] = dict(segments=rp.get("segments"),
                           n_evals=rp.get("n_evals"))
    rows = [ln for ln in render(records).splitlines()
            if ln.startswith("  refine")]

    def observed(row):
        try:
            return float(row.split()[5]) > 0.0
        except ValueError:
            return False
    out["planned"] = sum(len(p.get("segments", ())) for p in records
                         if p.get("type") == "plan")
    out["observed"] = sum(observed(r) for r in rows)
    out["report"] = (out["planned"] > 0 and len(rows) == out["planned"]
                     and out["observed"] == len(rows))
    return out


OBS_CHILD = r"""
import json, sys
from pathlib import Path
repo, root, pairs, placebo = sys.argv[1:5]
sys.path.insert(0, repo)
import chip_smoke
print(json.dumps(chip_smoke.obs_arms(Path(root), int(pairs),
                                     placebo == "placebo")), flush=True)
"""


def obs_child(root: Path, pairs: int = OBS_PAIRS,
              placebo: bool = False) -> dict:
    """``obs_arms`` in a fresh process (a small heap and no other phase's
    state, as a service process has)."""
    proc = subprocess.run(
        [sys.executable, "-c", OBS_CHILD, str(Path(__file__).parent),
         str(root), str(pairs), "placebo" if placebo else "journal"],
        capture_output=True, text=True, timeout=OBS_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"the bench_obs process failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def obs_check(problem, root: Path) -> dict:
    """(d): bench_obs's four gates on phase 5's query (non-adaptive, no
    reallocation, as bench_obs runs it, so every planned segment runs):
    overhead, identical fronts, journal replay and a complete report; then
    a cold ``Plan.predicted_s`` beside the wall it predicted."""
    arms = obs_child(root)
    on, off = arms["walls_on_s"], arms["walls_off_s"]
    o = obs_overhead(on, off)
    extra, se, t_off, gate = o["extra"], o["se"], o["t_off"], o["gate"]
    print(f"phase 14 (d) bench_obs: the journaled run costs {extra * 1e3:.1f}"
          f" +- {2e3 * se:.1f} ms more than its disabled pair (trimmed mean "
          f"of {len(on)} lockstep pairs ({OBS_MIN_PAIRS}-{OBS_PAIRS}, "
          f"ending once mean + 2 se < gate), +- 2 standard errors; overhead "
          f"{1.0 + extra / t_off:.4f} at the disabled "
          f"median {t_off:.4f} s; gate {gate * 1e3:.1f} ms; medians "
          f"{np.median(on):.4f} / {t_off:.4f} s, minima {min(on):.4f} / "
          f"{min(off):.4f} s, printed only); identical fronts "
          f"{arms['identical']}; replay {arms['replay']} "
          f"({arms['replayed']}); report {arms['report']} "
          f"({arms['observed']} of {arms['planned']} planned segments "
          f"observed); pareto_rank launches {arms['launches']} over "
          f"{len(on) + len(off)} runs")
    if extra > gate:
        fail(f"observability overhead: {extra * 1e3:.1f} ms a submission > "
             f"{gate * 1e3:.1f} ms")
    if arms["launches"] <= 0:
        fail("the observed search launched no pareto_rank kernel")
    if not (arms["identical"] and arms["replay"] and arms["report"]):
        fail(f"bench_obs gates: {arms}")
    # after one submission in this process, a cold plan predicts its wall
    policy = BudgetPolicy(adaptive=False, reallocate=False)
    q = Query(problem, budget=2048)
    Session(cache_dir=root / "first", device="cuda", policy=policy).submit(q)
    s = Session(cache_dir=root / "predict", device="cuda", policy=policy)
    predicted = s.plan(q).predicted_s
    if predicted is None:
        fail("a cold Plan.predicted_s is None after submissions ran")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.submit(q)
    actual = time.perf_counter() - t0
    print(f"phase 14 (d) cold plan: predicted_s {predicted:.4f} s, actual "
          f"wall {actual:.4f} s")
    return dict(arms, extra_s=extra, extra_se_s=se, off_median_s=t_off,
                overhead=1.0 + extra / t_off, gate_s=gate,
                median_ratio=float(np.median(on)) / t_off,
                min_ratio=min(on) / min(off), predicted_s=predicted,
                actual_s=actual)


def preset_serves(problem, val_res, root: Path) -> dict:
    """(e): (b)'s fit saved as an artifact into a temporary
    ``$REPRO_CALIB_DIR``, resolved by name, serving one NSGA query on the
    card; its provenance names the preset."""
    cal_dir = root / "calib"
    art = CalibratedTech.from_fit(CALIB_NAME, val_res)
    path = art.save(str(cal_dir))
    if load_calibrated(path).digest != art.digest:
        fail("the saved artifact does not load to its digest")
    os.environ["REPRO_CALIB_DIR"] = str(cal_dir)
    try:
        if tech_key(presets.tech_preset(CALIB_NAME)) != art.digest:
            fail("the preset does not resolve to the artifact")
        pareto_ops.dominance_counts.launches = 0
        r, rec = timed_submit(Session(cache_dir=root / "served",
                                      tech=CALIB_NAME, device="cuda"),
                              Query(problem, budget=2048))
    finally:
        os.environ.pop("REPRO_CALIB_DIR", None)
    pv = r.provenance
    if rec["launches"]["pareto_rank"] <= 0:
        fail("the calibrated query launched no pareto_rank kernel")
    if pv.tech != f"{CALIB_NAME}@{art.digest[:12]}" or pv.n_evals_run <= 0:
        fail(f"the calibrated query: tech {pv.tech}, {pv.n_evals_run} "
             f"evaluations")
    check_front(problem, r, art.tech)
    print(f"phase 14 (e) preset {pv.tech}: {rec['evals']} evaluations in "
          f"{rec['wall_s']:.3f} s, front {len(r.front_objs)} points, "
          f"pareto_rank launches {rec['launches']['pareto_rank']}")
    return dict(tech=pv.tech, **rec)


def calib_obs_phase(problem) -> dict:
    """Phase 14: calibration and the flight recorder on the card."""
    t0 = time.perf_counter()
    out, walls = {}, {}

    def part(name, fn):
        t1 = time.perf_counter()
        r = fn()
        walls[name] = time.perf_counter() - t1
        return r

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        out["fit"] = part("fit", lambda: calib_fit_check(
            simulator_sweep() + baseline_measurements()))
        val_res, out["validation"] = part("validation", validation_arm)
        out["jacobian"] = part("jacobian", jacobian_check)
        out["obs"] = part("obs", lambda: obs_check(problem, root / "obs"))
        out["preset"] = part("preset", lambda: preset_serves(
            problem, val_res, root))
    out.update(wall_s=time.perf_counter() - t0, part_walls_s=walls)
    print(f"phase 14: {out['wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out

# ---- 15. the async serving shell ------------------------------------------
# (a) the reference's serving benchmark (benchmarks/bench_serve.py:175-184)
# at its full settings: budget 256, 16 fleet clients, 4 overload clients, a
# 900 s deadline, on its problem (one matmul 512 x 512 x k, ch_max=2,
# max_shape=(16, 16, 4, 4, 1, 2)) at pop 8, one generation a segment, no
# plateau stop, no reallocation
SV_OBJ = ("latency_ns", "cost_usd")
SV_SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
SV_NSGA_KW = dict(pop=8, generations=2)
SV_POLICY_KW = dict(chunk_generations=1, adaptive=False, reallocate=False)
SV_BUDGET = 256
SV_CLIENTS = 16
SV_OVERLOAD_CLIENTS = 4
SV_DEADLINE_S = 900.0
# (b) the fleet at real size, two arms.  The replay arm: phase 5's query
# (budget 2048, pop 64, the default policy less reallocation) for 8
# clients through one Executor with 2 worker threads, with bench_serve's
# warm / refine (twice the budget on a warmed archive) / cold kinds, each
# client on a transformer block of its own (phase 5's seq 512 among them,
# the cold ones at seq 1024 and 1536) and held to its sequential replay bit
# for bit.  A mix built for that check, not traffic: clients of one
# problem race on its archive, and a replay could not be held to them.
# The shared arm (serve_mix) runs bench_serve's own mix at phase 5's size
FLEET_MIX = (("warm", 512), ("refine", 256), ("cold", 1024), ("warm", 384),
             ("refine", 640), ("cold", 1536), ("warm", 768),
             ("refine", 896))
FLEET_WORKERS = 2
FLEET_WARM_KEY = 100
# without reallocation: the ledger of banked evaluations is a service's
# memory, which each worker thread's clone keeps across the jobs it runs,
# so reallocated spend would depend on which jobs a worker ran before
FLEET_POLICY_KW = dict(reallocate=False)
# the busy share is read over three short windows of each arm
BUSY_STARTS_S = (1.5, 3.5, 5.5)
BUSY_WINDOW_S = 0.5
# (c): phase 5's query.  (d), (e): phase 5's query at two generations a
# segment without the plateau stop (16 segments, so a cancel or a kill
# lands mid-run); (d) kills the worker 0.3 s into the 1 s pause after its
# first checkpointed segment
SV_CHUNK = 2
SV_SEED = 5
SV_KILL_TIMEOUT_S = 300


def sv_problem(k: int):
    """bench_serve's problem: one matmul 512 x 512 x ``k``."""
    return Problem(WorkloadGraph([matmul("mm", 512, 512, k)], []), SV_OBJ,
                   ch_max=2, space_kwargs=SV_SPACE_KW)


def sv_session(cache: Path, device: str = "cuda"):
    return Session(cache_dir=cache, nsga=NSGAConfig(**SV_NSGA_KW),
                   policy=BudgetPolicy(**SV_POLICY_KW), device=device)


def sv_policy():
    """(d) and (e)'s policy; the workers get it as ``--chunk-generations
    2 --no-adaptive``."""
    return BudgetPolicy(chunk_generations=SV_CHUNK, adaptive=False)


def sync_of(device: str):
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def quantiles(walls: list) -> tuple:
    """(p50, p99) of a list of walls, as bench_serve reads them."""
    lat = sorted(walls)
    return lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def same_front(a, b) -> bool:
    return (a.front_objs.tobytes() == b.front_objs.tobytes()
            and a.front_metrics.tobytes() == b.front_metrics.tobytes())


def run_clients(ex, queries, deadline_s: float, during=None) -> tuple:
    """One client thread a query (client ``i`` takes seed ``i``): submit
    through ``ex``, take the stale front if admission served one, else
    wait for the final result.  ``during`` runs on this thread while the
    clients do.  Returns (results, time to front of each, wall, what
    ``during`` returned); a client that raised fails the run."""
    n = len(queries)
    results, ttf, ends, errs = [None] * n, [None] * n, [], []

    def client(i):
        try:
            t0 = time.perf_counter()
            h = ex.submit(queries[i], key=i, deadline_s=1.0)
            r = h.stale if h.stale is not None else h.result(deadline_s)
            ends.append(time.perf_counter())
            ttf[i] = ends[-1] - t0
            results[i] = r
        except BaseException as e:          # re-raised below
            errs.append(e)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    seen = during() if during is not None else None
    for t in threads:
        t.join(deadline_s)
    if errs:
        raise errs[0]
    return results, ttf, max(ends, default=t0) - t0, seen


def bench_serve_arms(root: Path, device: str = "cuda",
                     budget: int = SV_BUDGET, clients: int = SV_CLIENTS,
                     overload: int = SV_OVERLOAD_CLIENTS,
                     deadline_s: float = SV_DEADLINE_S) -> dict:
    """(a): bench_serve's fleet, overload and resume arms with its gates."""
    sv_session(root / "warmup", device).submit(
        Query(sv_problem(64), budget=budget))
    # fleet: mixed warm / refine / cold clients through one executor
    sess = sv_session(root / "fleet", device)
    p_warm, p_cold = sv_problem(64), sv_problem(96)
    sess.submit(Query(p_warm, budget=budget))
    ex = Executor(sess, store=root / "fleet_jobs", max_workers=2,
                  max_pending=max(4, clients))
    mix = [Query(p_warm, budget=budget), Query(p_warm, budget=2 * budget),
           Query(p_cold, budget=budget)]
    results, ttf, wall, _ = run_clients(
        ex, [mix[i % len(mix)] for i in range(clients)], deadline_s)
    ex.shutdown()
    served = sum(r is not None for r in results)
    if served != clients:
        fail(f"phase 15 (a) fleet: {served} of {clients} clients served")
    p50, p99 = quantiles(ttf)
    fleet = dict(wall_s=wall, p50_s=p50, p99_s=p99,
                 hit_rate=sum(r.provenance.from_cache
                              for r in results) / clients,
                 total_evals=sum(r.provenance.n_evals_run for r in results),
                 ttf_s=ttf)
    # overload: zero slots; warm queries degrade to the cached front
    sess = sv_session(root / "overload", device)
    p = sv_problem(64)
    sess.submit(Query(p, budget=budget))
    ex = Executor(sess, store=root / "overload_jobs", max_workers=1,
                  max_pending=0)
    t0 = time.perf_counter()
    handles = [ex.submit(Query(p, budget=budget), key=i, deadline_s=0.0)
               for i in range(overload)]
    stale_s = time.perf_counter() - t0
    n_stale = sum(h.stale is not None for h in handles)
    if n_stale != overload or not all(
            h.stale.provenance.stale and h.stale.provenance.n_evals_run == 0
            for h in handles) or stale_s >= deadline_s:
        fail(f"phase 15 (a) overload: {n_stale} of {overload} served stale "
             f"in {stale_s:.3f} s")
    resumed = ex.resume_pending()
    for h in resumed:
        h.result(deadline_s)
    ex.shutdown()
    states = [h.state() for h in resumed]
    if len(resumed) != overload or any(s != DONE for s in states):
        fail(f"phase 15 (a) overload: banked jobs ended {states}")
    over = dict(n_stale=n_stale, stale_serve_s=stale_s,
                banked_drained=len(resumed))
    # resume: interrupted at a segment boundary, resumed in a fresh session
    sync = sync_of(device)
    q = Query(sv_problem(64), budget=budget)
    sync()
    t0 = time.perf_counter()
    r_full = sv_session(root / "full", device).submit(q, key=11)
    sync()
    t_full = time.perf_counter() - t0
    ctl = RunControl()
    seen = []

    def stop_after_two(ev):
        seen.append(ev)
        if len(seen) == 2:
            ctl.stop()
    t0 = time.perf_counter()
    r_int = sv_session(root / "crash", device).submit(
        q, key=11, resume=True, control=ctl, on_segment=stop_after_two)
    sync()
    t_int = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_res = sv_session(root / "crash", device).submit(q, key=11,
                                                      resume=True)
    sync()
    t_res = time.perf_counter() - t0
    identical = same_front(r_res, r_full)
    spend_ok = (r_int.provenance.n_evals_run + r_res.provenance.n_evals_run
                == r_full.provenance.n_evals_run)
    if not (r_int.provenance.interrupted and identical and spend_ok):
        fail(f"phase 15 (a) resume: interrupted "
             f"{r_int.provenance.interrupted}, identical {identical}, "
             f"spend {r_int.provenance.n_evals_run} + "
             f"{r_res.provenance.n_evals_run} against "
             f"{r_full.provenance.n_evals_run}")
    resume = dict(t_full_s=t_full, t_interrupted_s=t_int, t_resumed_s=t_res,
                  overhead=(t_int + t_res) / t_full, identical=identical,
                  spend_ok=spend_ok)
    print(f"phase 15 (a) bench_serve fleet: {clients} clients served in "
          f"{wall:.3f} s, time to front p50 {p50:.4f} s / p99 {p99:.4f} s, "
          f"hit rate {fleet['hit_rate']:.2f}, {fleet['total_evals']} "
          f"evaluations; overload: {n_stale} of {overload} served stale "
          f"in {stale_s * 1e3:.2f} ms, {len(resumed)} banked jobs drained "
          f"to DONE; resume: identical {identical}, residual spend "
          f"{spend_ok} ({r_int.provenance.n_evals_run} + "
          f"{r_res.provenance.n_evals_run}), overhead "
          f"{resume['overhead']:.3f} ({t_int:.3f} + {t_res:.3f} s against "
          f"{t_full:.3f} s)")
    return dict(fleet=fleet, overload=over, resume=resume)


def fleet_queries(budget: int, ch_max: int = 4) -> list:
    """(b)'s eight clients: (kind, query) in client order."""
    out = []
    for kind, seq in FLEET_MIX:
        p = Problem(presets.transformer_block(seq=seq), SV_OBJ,
                    ch_max=ch_max)
        out.append((kind, Query(p, budget=2 * budget if kind == "refine"
                                else budget)))
    return out


def busy_windows(device: str, starts=BUSY_STARTS_S,
                 window_s: float = BUSY_WINDOW_S) -> list:
    """``torch.profiler`` recordings (device activity only) of the
    ``window_s``-second windows that start ``starts`` seconds from now,
    each with its wall; empty on the CPU.  Windows, not a whole run: the
    fleet launches ~10^5 kernels a second.  ``busy_of`` reads them once
    the run is over: reading holds the interpreter for seconds, which would
    stall the threads being measured."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    out = []
    for start in starts:
        time.sleep(max(0.0, t0 + start - time.perf_counter()))
        if device != "cuda":
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            time.sleep(window_s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        out.append((prof, wall))
    return out


def busy_of(windows: list) -> list:
    """(device busy share, kernels) of each ``busy_windows`` recording."""
    from torch.autograd import DeviceType
    out = []
    for prof, wall in windows:
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        out.append((sum(e.self_device_time_total for e in dev) * 1e-6
                    / wall, sum(e.count for e in dev)))
    return out


def busy_text(windows: list) -> str:
    if not windows:
        return "not measured"
    return (f"{np.mean([b for b, _ in windows]):.1%} (windows "
            + " / ".join(f"{b:.1%}" for b, _ in windows) + ", kernels "
            + " / ".join(str(k) for _, k in windows) + ")")


def serve_fleet(root: Path, device: str = "cuda", budget: int = 2048,
                ch_max: int = 4, deadline_s: float = SV_DEADLINE_S,
                workers: int = FLEET_WORKERS) -> dict:
    """(b): eight clients of phase 5's query through one Executor with
    ``workers`` worker threads, then the same jobs one after another in a
    fresh session: each job's front and spend, and the launch total,
    agree."""
    queries = fleet_queries(budget, ch_max)

    def session(cache):
        return Session(cache_dir=cache, device=device,
                       policy=BudgetPolicy(**FLEET_POLICY_KW))
    warm = session(root / "fleet")
    for i, (kind, q) in enumerate(queries):
        if kind != "cold":
            warm.submit(Query(q.problem, budget=budget),
                        key=FLEET_WARM_KEY + i)
    shutil.copytree(root / "fleet", root / "replay")
    ex = Executor(session(root / "fleet"), store=root / "fleet_jobs",
                  max_workers=workers, max_pending=len(queries))
    pareto_ops.dominance_counts.launches = 0
    results, ttf, wall, windows = run_clients(
        ex, [q for _, q in queries], deadline_s,
        during=lambda: busy_windows(device))
    launches = pareto_ops.dominance_counts.launches
    ex.shutdown()
    if any(r is None or r.provenance.stale for r in results):
        fail("phase 15 (b): a fleet client was not served a final front")
    if device == "cuda" and launches <= 0:      # the CPU counts none
        fail("phase 15 (b): the fleet launched no pareto_rank kernel")
    replay = session(root / "replay")
    seq = []

    def one_by_one():
        t0 = time.perf_counter()
        seq.extend(replay.submit(q, key=i)
                   for i, (_, q) in enumerate(queries))
        sync_of(device)()
        seq.append(time.perf_counter() - t0)
    pareto_ops.dominance_counts.launches = 0
    worker = threading.Thread(target=one_by_one)
    worker.start()
    seq_windows = busy_windows(device)
    worker.join()
    busy, seq_busy = busy_of(windows), busy_of(seq_windows)
    seq_wall = seq.pop() if len(seq) == len(queries) + 1 else None
    seq_launches = pareto_ops.dominance_counts.launches
    if len(seq) != len(queries):
        fail("phase 15 (b): the sequential replay failed")
    agree = [same_front(a, b) and a.provenance.n_evals_run
             == b.provenance.n_evals_run
             and a.provenance.from_cache == b.provenance.from_cache
             for a, b in zip(results, seq)]
    p50, p99 = quantiles(ttf)
    evals = sum(r.provenance.n_evals_run for r in results)
    out = dict(wall_s=wall, p50_s=p50, p99_s=p99, ttf_s=ttf,
               kinds=[k for k, _ in queries],
               evals=[r.provenance.n_evals_run for r in results],
               from_cache=[r.provenance.from_cache for r in results],
               hit_rate=sum(r.provenance.from_cache for r in results)
               / len(results),
               evals_per_s=evals / wall, seq_evals_per_s=evals / seq_wall,
               launches=launches, seq_launches=seq_launches,
               seq_wall_s=seq_wall, agree=agree, busy_share=busy,
               seq_busy_share=seq_busy, workers=workers)

    print(f"phase 15 (b) fleet of {len(queries)} clients (phase 5's query, "
          f"{workers} worker thread{'s' * (workers != 1)}): all served in "
          f"{wall:.3f} s "
          f"({out['evals_per_s']:.1f} evaluations/s), time to front p50 "
          f"{p50:.4f} s / p99 {p99:.4f} s, hit rate {out['hit_rate']:.2f}, "
          f"evaluations {out['evals']}, device busy {busy_text(busy)} "
          f"over {BUSY_WINDOW_S} s windows, pareto_rank launches "
          f"{launches}; the same jobs one after another in {seq_wall:.3f} s "
          f"({out['seq_evals_per_s']:.1f} evaluations/s), device busy "
          f"{busy_text(seq_busy)}, pareto_rank launches {seq_launches}; "
          f"fronts and spend equal per job: {agree}")
    if not all(agree) or launches != seq_launches:
        fail(f"phase 15 (b): the concurrent fleet differs from its "
             f"sequential replay (per job {agree}, launches {launches} "
             f"against {seq_launches})")
    return out


def serve_mix(root: Path, problem, device: str = "cuda", budget: int = 2048,
              clients: int = len(FLEET_MIX),
              deadline_s: float = SV_DEADLINE_S) -> dict:
    """(b), the shared arm: bench_serve's fleet arm at phase 5's size.
    ``problem`` (phase 5's) is warmed at ``budget``; then ``clients``
    clients in bench_serve's round-robin mix — warm, refine at twice the
    budget, cold on ``transformer_block(seq=1024)`` — go through one
    Executor with 2 worker threads under the default policy.  Warm and
    refine clients share one archive, and each worker's clone keeps its
    reallocation ledger between jobs, so nothing holds these fronts to a
    replay.  Gates: every client is served a final front within the
    deadline; each job spends at most its budget's schedule plus the
    credit it was granted; the credit granted is at most what the fleet's
    jobs banked (each clone's ledger starts empty)."""
    sess = Session(cache_dir=root / "cache", device=device)
    p_cold = Problem(presets.transformer_block(seq=1024), SV_OBJ, ch_max=4)
    sess.submit(Query(problem, budget=budget))
    ex = Executor(sess, store=root / "jobs", max_workers=FLEET_WORKERS,
                  max_pending=max(4, clients))
    mix = [Query(problem, budget=budget), Query(problem, budget=2 * budget),
           Query(p_cold, budget=budget)]
    queries = [mix[i % len(mix)] for i in range(clients)]
    pareto_ops.dominance_counts.launches = 0
    results, ttf, wall, _ = run_clients(ex, queries, deadline_s)
    launches = pareto_ops.dominance_counts.launches
    ex.shutdown()
    if any(r is None or r.provenance.stale for r in results):
        fail("phase 15 (b) shared: a client was not served a final front")
    svc = sess.service
    caps = [quantize.schedule(q.budget, svc.nsga.pop,
                              svc.policy.chunk_generations).evals
            for q in queries]
    pv = [r.provenance for r in results]
    evals = [v.n_evals_run for v in pv]
    granted = [v.n_evals_realloc for v in pv]
    banked = [v.n_evals_banked for v in pv]
    over = [i for i, (v, c) in enumerate(zip(pv, caps))
            if v.n_evals_run - v.n_evals_realloc > c]
    p50, p99 = quantiles(ttf)
    out = dict(wall_s=wall, p50_s=p50, p99_s=p99, ttf_s=ttf, evals=evals,
               caps=caps, granted=granted, banked=banked,
               from_cache=[v.from_cache for v in pv],
               hit_rate=sum(v.from_cache for v in pv) / clients,
               launches=launches)
    print(f"phase 15 (b) shared mix of {clients} clients (bench_serve's "
          f"warm / refine / cold at phase 5's query, the default policy, "
          f"{FLEET_WORKERS} worker threads): all served in {wall:.3f} s, "
          f"time to front p50 {p50:.4f} s / p99 {p99:.4f} s, hit rate "
          f"{out['hit_rate']:.2f}, evaluations {evals} (caps {caps}), "
          f"credit granted {granted}, banked {banked}, pareto_rank "
          f"launches {launches}")
    if over or sum(granted) > sum(banked):
        fail(f"phase 15 (b) shared: clients {over} spent past their budget "
             f"and credit, or {sum(granted)} evaluations of credit were "
             f"granted of {sum(banked)} banked")
    if device == "cuda" and launches <= 0:
        fail("phase 15 (b) shared: no pareto_rank kernel was launched")
    return out


def async_equals_sync(root: Path, problem, device: str = "cuda",
                      budget: int = 2048, deadline_s: float = SV_DEADLINE_S
                      ) -> dict:
    """(c): a ``submit_async`` job equals ``Session.submit`` of its query
    and seed bit for bit while another job runs in the second worker
    thread; the two jobs' segments are seen to interleave."""
    q = Query(problem, budget=budget)
    other = Query(Problem(presets.transformer_block(seq=1024), SV_OBJ,
                          ch_max=problem.ch_max), budget=budget)
    sync = Session(cache_dir=root / "sync", device=device).submit(
        q, key=SV_SEED)
    s = Session(cache_dir=root / "async", device=device)
    s.executor(max_workers=2)
    h_other = s.submit_async(other, key=1)
    h = s.submit_async(q, key=SV_SEED)
    stamps = {}

    def drain(tag, handle):
        stamps[tag] = [time.perf_counter()
                       for _ in handle.events(timeout=deadline_s)]
    threads = [threading.Thread(target=drain, args=a)
               for a in (("job", h), ("other", h_other))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    r = h.result(deadline_s)
    h_other.result(deadline_s)
    s.executor().shutdown()
    overlap = (bool(stamps["job"]) and bool(stamps["other"])
               and stamps["job"][0] < stamps["other"][-1]
               and stamps["other"][0] < stamps["job"][-1])
    identical = same_front(r, sync) and (r.provenance.n_evals_run
                                         == sync.provenance.n_evals_run)
    print(f"phase 15 (c) submit_async: {r.provenance.n_evals_run} "
          f"evaluations, front bit-identical to Session.submit's: "
          f"{identical}; segments interleaved with the other job's: "
          f"{overlap} ({len(stamps['job'])} and {len(stamps['other'])} "
          f"segments)")
    if not (identical and overlap):
        fail(f"phase 15 (c): identical {identical}, overlap {overlap}")
    return dict(identical=identical, overlap=overlap,
                evals=r.provenance.n_evals_run)


def kill_drill(root: Path, problem, device: str = "cuda",
               budget: int = 2048) -> tuple:
    """(d): a worker process (``python -m repro_torch.serve.worker``) is
    SIGKILLed after its first checkpointed segment; a second worker
    recovers the job, resumes it and lands on the uninterrupted run's
    archive byte for byte, spending only the residual budget.  Returns
    (readings, the uninterrupted result)."""
    q = Query(problem, budget=budget)
    policy = sv_policy()
    t0 = time.perf_counter()
    base = Session(cache_dir=root / "base", policy=policy,
                   device=device).submit(q, key=SV_SEED)
    sync_of(device)()
    base_s = time.perf_counter() - t0
    cache, store_dir = root / "cache", root / "store"
    ck = Session(cache_dir=cache, policy=policy,
                 device=device)._cache_key(problem)
    store = JobStore(store_dir)
    rec = store.create(query_to_payload(q), problem.key(), ck, SV_SEED)
    cmd = [sys.executable, "-m", "repro_torch.serve.worker", "--store",
           str(store_dir), "--cache", str(cache), "--once",
           "--chunk-generations", str(SV_CHUNK), "--no-adaptive",
           "--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent / "src")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    ckpt = cache / f"{ck}.ckpt.npz"
    t0 = time.perf_counter()
    w1 = subprocess.Popen(cmd + ["--segment-delay", "1.0"], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    try:
        deadline = time.monotonic() + SV_KILL_TIMEOUT_S
        while not ckpt.exists():
            if w1.poll() is not None:
                fail(f"phase 15 (d): the worker exited {w1.returncode} "
                     f"before its first checkpoint: "
                     f"{w1.communicate()[1][-2000:]}")
            if time.monotonic() > deadline:
                fail("phase 15 (d): no checkpoint appeared")
            time.sleep(0.05)
        to_ckpt = time.perf_counter() - t0
        time.sleep(0.3)                     # inside the 1 s pause
        w1.send_signal(signal.SIGKILL)
        w1.wait(timeout=30)
    finally:
        if w1.poll() is None:
            w1.kill()
        w1.communicate()
    after = store.get(rec.job_id)
    if after.state != RUNNING or not ckpt.exists():
        fail(f"phase 15 (d): after the kill the job is {after.state}, "
             f"checkpoint kept {ckpt.exists()}")
    t0 = time.perf_counter()
    w2 = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=SV_KILL_TIMEOUT_S)
    second_s = time.perf_counter() - t0
    if w2.returncode != 0:
        fail(f"phase 15 (d): the second worker exited {w2.returncode}: "
             f"{w2.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in w2.stdout.splitlines() if ln]
    done = [ln for ln in lines if ln.get("state") == DONE]
    recovered = any(ln.get("state") == "RECOVERED" for ln in lines)
    full = base.provenance.n_evals_run
    mine = ParetoArchive.load(cache / f"{ck}.npz", device="cpu")
    ref = ParetoArchive.load(root / "base" / f"{ck}.npz", device="cpu")
    identical = (mine.objs[mine.valid].numpy().tobytes()
                 == ref.objs[ref.valid].numpy().tobytes()
                 and all(torch.equal(mine.designs[k][mine.valid],
                                     ref.designs[k][ref.valid])
                         for k in ref.designs))
    residual = done[0]["n_evals_attempts"][-1] if done else None
    out = dict(to_checkpoint_s=to_ckpt, second_worker_s=second_s,
               uninterrupted_s=base_s, residual_evals=residual,
               full_evals=full, identical=identical, recovered=recovered,
               attempts=done[0]["attempts"] if done else None)
    print(f"phase 15 (d) SIGKILL drill: first checkpoint {to_ckpt:.2f} s "
          f"after the worker started, killed 0.3 s later; the second "
          f"worker recovered the job ({recovered}), ended DONE after "
          f"{out['attempts']} attempts in {second_s:.2f} s spending "
          f"{residual} of {full} evaluations; archive byte-identical to "
          f"the uninterrupted run's ({base_s:.3f} s): {identical}")
    if not (recovered and len(done) == 1 and out["attempts"] == 2
            and residual is not None and 0 < residual < full and identical
            and int(mine.n_evals) == int(ref.n_evals)
            and not ckpt.exists()):
        fail(f"phase 15 (d): {out}, lines {lines}")
    return out, base


def cancel_check(root: Path, problem, base, device: str = "cuda",
                 budget: int = 2048, deadline_s: float = SV_DEADLINE_S
                 ) -> dict:
    """(e): cancelling a RUNNING job keeps its checkpoint; the query
    recorded again in the store (as a client process would) is picked up by
    a fresh executor's ``resume_pending``, which resumes the checkpoint and
    lands on the uninterrupted front, spending only the rest."""
    q = Query(problem, budget=budget)
    s = Session(cache_dir=root / "cache", device=device, policy=sv_policy())
    ex = Executor(s, store=root / "jobs", max_workers=1)
    h = ex.submit(q, key=SV_SEED)
    next(h.events(timeout=deadline_s))      # one segment done, then cancel
    h.cancel()
    try:
        h.result(deadline_s)
        fail("phase 15 (e): the cancelled job returned a result")
    except CancelledError:
        pass
    ex.shutdown()
    rec = h.record()
    ckpt = s.service._ckpt_path(s._cache_key(problem))
    if rec.state != CANCELLED or not ckpt.exists():
        fail(f"phase 15 (e): cancelled job {rec.state}, checkpoint kept "
             f"{ckpt.exists()}")
    first = rec.n_evals_attempts[-1]
    again = ex.store.create(query_to_payload(q), problem.key(),
                            s._cache_key(problem), SV_SEED)
    ex = Executor(s, store=root / "jobs", max_workers=1)
    handles = ex.resume_pending()
    r = handles[0].result(deadline_s) if len(handles) == 1 else None
    ex.shutdown()
    rest = r.provenance.n_evals_run if r is not None else None
    identical = r is not None and same_front(r, base)
    print(f"phase 15 (e) cancel: stopped after {first} evaluations "
          f"({rec.state}, checkpoint kept); recorded again, resume_pending "
          f"ran {[x.job_id == again.job_id for x in handles]} and finished "
          f"it with {rest} more (uninterrupted "
          f"{base.provenance.n_evals_run}); front identical to the "
          f"uninterrupted run's: {identical}")
    if not (identical and handles[0].job_id == again.job_id
            and first + rest == base.provenance.n_evals_run
            and not ckpt.exists()):
        fail(f"phase 15 (e): resumed {len(handles)}, identical {identical},"
             f" spend {first} + {rest}")
    return dict(first_evals=first, rest_evals=rest, identical=identical)


def serve_phase(problem, device: str = "cuda") -> dict:
    """Phase 15: the async serving shell on the card."""
    t0 = time.perf_counter()
    out, walls = {}, {}

    def part(name, fn):
        t1 = time.perf_counter()
        r = fn()
        walls[name] = time.perf_counter() - t1
        print(f"phase 15 {name}: {walls[name]:.1f} s", flush=True)
        return r

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        out["bench_serve"] = part("bench_serve", lambda: bench_serve_arms(
            root / "a", device))
        out["fleet"] = part("fleet", lambda: serve_fleet(root / "b", device))
        out["shared"] = part("shared", lambda: serve_mix(
            root / "b2", problem, device))
        out["async"] = part("async", lambda: async_equals_sync(
            root / "c", problem, device))
        out["kill"], base = part("kill", lambda: kill_drill(
            root / "d", problem, device))
        out["cancel"] = part("cancel", lambda: cancel_check(
            root / "e", problem, base, device))
    out.update(wall_s=time.perf_counter() - t0, part_walls_s=walls)
    print(f"phase 15: {out['wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# ---- 16. every LM family on the card --------------------------------------
# (a) each family served in bf16 activations with float32 weights from a
# seed: batch 4, a 1024-token prompt, 32 new tokens through ``generate``.
# internlm2-1.8b (the slice's path) and falcon-mamba-7b at full size;
# qwen2-vl-72b, deepseek-v2-236b and grok-1-314b at full width with depth
# cut to fit one 80 GB card; whisper-tiny at full size (the encoder input
# is the reference's 1500-frame stub).  (arch, layers or None = as
# configured)
FAMILY_SERVE = (("internlm2-1.8b", None), ("falcon-mamba-7b", None),
                ("qwen2-vl-72b", 2), ("deepseek-v2-236b", 2),
                ("grok-1-314b", 1), ("whisper-tiny", None))
# (b) one full-width card-vs-CPU check a family, float32, batch 1, a
# 64-token prompt, 4 decode steps (grok-1 runs on the card only)
FAMILY_PARITY = (("internlm2-1.8b", 2), ("falcon-mamba-7b", 1),
                 ("qwen2-vl-72b", 1), ("deepseek-v2-236b", 1),
                 ("whisper-tiny", None))
PARITY_PROMPT, PARITY_STEPS = 64, 4
# the pinned buffer that (b) stages the weights through on their way to
# the CPU
STAGE_BYTES = 1 << 28
# two experts' router probabilities closer than this are a tie that the
# two devices may break apart
ROUTE_TIE = 1e-5


def family_cfg(arch: str, layers, dtype: str = None):
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def expected_launches(cfg, full_calls: int, steps: int) -> dict:
    """The attention and scan launches of ``full_calls`` full-sequence
    calls (forward or prefill) and ``steps`` decode steps: one attention
    launch a layer a call (two for whisper's decoder, self and cross, and
    one an encoder layer in a full call), one scan a Mamba layer a call."""
    per_step = {"ssm": 0, "encdec": 2 * cfg.n_layers}.get(cfg.family,
                                                          cfg.n_layers)
    scans = cfg.n_layers if cfg.family == "ssm" else 0
    return dict(flash_attention=full_calls * (per_step + cfg.enc_layers)
                + steps * per_step,
                mamba_scan=(full_calls + steps) * scans)


def reset_lm_counts():
    fa_ops.flash_attention.launches = fa_ops.flash_attention.launches_tc = 0
    ms_ops.selective_scan.launches = 0


def lm_counts() -> dict:
    return dict(flash_attention=fa_ops.flash_attention.launches,
                flash_attention_tc=fa_ops.flash_attention.launches_tc,
                mamba_scan=ms_ops.selective_scan.launches)


def free_card():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def family_serve(arch: str, layers) -> dict:
    """(a) for one family: two ``generate`` runs with the counts set to 0
    just before the first and read just after it."""
    cfg = family_cfg(arch, layers)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(16)
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen)
    inputs = stub_inputs(cfg, SERVE_BATCH, SERVE_PROMPT, gen)
    torch.cuda.reset_peak_memory_stats()
    reset_lm_counts()
    first = generate(model, params, prompt, SERVE_TOKENS, **inputs)
    launches = lm_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, 1, SERVE_TOKENS - 1)
    want["flash_attention_tc"] = want["flash_attention"]
    if launches != want:
        fail(f"{cfg.name} serve launched {launches}, expected {want} (every "
             f"bf16 attention on the tensor-core kernel)")
    if not bool(torch.isfinite(first.logits).all()):
        fail(f"{cfg.name} serve: non-finite logits")
    again = generate(model, params, prompt, SERVE_TOKENS, **inputs)
    if not torch.equal(first.tokens, again.tokens):
        fail(f"{cfg.name} serve: two runs gave different tokens")
    split = prefill_and_step_launches(model, params, prompt, inputs, first)
    steps = SERVE_TOKENS - 1
    out = dict(arch=arch, layers=cfg.n_layers, launch_split=split,
               cut=None if layers is None else
               f"{get_config(arch).n_layers} -> {layers} layers",
               params=sum(p.numel() for p in params.parameters()),
               init_s=init_s, launches=launches, peak_bytes=peak,
               runs=[dict(prefill_s=g.prefill_s, decode_s=g.decode_s,
                          decode_ms_per_token=g.decode_s / steps * 1e3,
                          tokens_per_s=SERVE_BATCH * SERVE_TOKENS
                          / (g.prefill_s + g.decode_s))
                     for g in (first, again)])
    for i, run in enumerate(out["runs"]):
        print(f"phase 16 {cfg.name} run {i + 1} ({cfg.n_layers} layers"
              f"{'' if layers is None else ', cut ' + out['cut']}, batch "
              f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_TOKENS} tokens):"
              f" prefill {run['prefill_s']:.4f} s, decode "
              f"{run['decode_ms_per_token']:.3f} ms/token, "
              f"{run['tokens_per_s']:.1f} tokens/s")
    print(f"phase 16 {cfg.name}: {out['params']} parameters "
          f"({out['params'] * 4 / 1e9:.2f} GB float32), init {init_s:.2f} s,"
          f" launches per request {launches} (prefill "
          f"{split['prefill']}, a decode step {split['decode_step']}), peak "
          f"device memory "
          f"{peak / 2**30:.3f} GiB, first sequence {first.tokens[0].tolist()}")
    if arch == FAMILY_SERVE[0][0]:
        out.update(decode_step_profile(model, params, prompt, first, cfg))
    del params, model
    free_card()
    return out


def prefill_and_step_launches(model, params, prompt, inputs,
                              first) -> dict:
    """The launches of one prefill and of one decode step, each counted
    from 0 and held to ``expected_launches``."""
    cfg = model.cfg
    batch = {"tokens": prompt} | inputs
    base = SERVE_PROMPT + cfg.meta_tokens
    out = {}
    with AttentionShapes() as shapes:
        reset_lm_counts()
        _, cache = model.prefill(params, batch, model.init_cache(
            SERVE_BATCH, base + SERVE_TOKENS + 1))
        out["prefill"] = lm_counts()
        reset_lm_counts()
        model.decode_step(params, first.tokens[:, :1], cache, base)
        out["decode_step"] = lm_counts()
    unchecked = sorted(shapes.seen - {s[:-1] for s in FA_SHAPES}, key=str)
    if unchecked:
        fail(f"{cfg.name}: attention launched at shapes that phase 3 does "
             f"not hold against the plain version: {unchecked}")
    for part, calls in (("prefill", (1, 0)), ("decode_step", (0, 1))):
        want = expected_launches(cfg, *calls)
        want["flash_attention_tc"] = want["flash_attention"]
        if out[part] != want:
            fail(f"{cfg.name}: {part} launched {out[part]}, expected {want}")
    return out


def decode_step_profile(model, params, prompt, first, cfg) -> dict:
    """One decode step of the headline family alone: wall (synchronized)
    and, under the profiler, device time, kernel count and split."""
    base = SERVE_PROMPT + cfg.meta_tokens
    _, cache = model.prefill(params, {"tokens": prompt}, model.init_cache(
        SERVE_BATCH, base + SERVE_TOKENS + 1))
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
    out = dict(decode_step_s=step_s)
    if device_s <= 0:
        print(f"phase 16 {cfg.name} decode step: {step_s * 1e3:.3f} ms wall;"
              f" device busy share not measured (the profiler saw no device "
              f"events)")
        return out
    out.update(decode_step_device_s=device_s,
               decode_step_busy_share=device_s / step_s,
               decode_step_kernels=n_kernels,
               decode_step_split=kernel_split(by_name, device_s))
    attn = out["decode_step_split"]["flash_attention_tc"]
    print(f"phase 16 {cfg.name} decode step: {step_s * 1e3:.3f} ms wall; "
          f"under the profiler {device_s * 1e3:.3f} ms device time = "
          f"{device_s / step_s:.1%} of that wall, {n_kernels} kernels; "
          f"attention {attn['count']} tensor-core launches, "
          f"{attn['s'] * 1e3:.3f} ms; split "
          f"{json.dumps(out['decode_step_split'])}")
    return out


class AttentionShapes:
    """Records the (B, Sq, Sk, H, KV, D, Dv, mask, window, kv_valid_len)
    of every attention the layers call while active, in FA_SHAPES' form."""

    def __enter__(self):
        self.seen = set()
        self._orig = Ly.flash_attention

        def attend(q, k, v, mask_kind="causal", window=0, kv_valid_len=None):
            (B, Sq, H, D), (Sk, KV, Dv) = q.shape, (*k.shape[1:3],
                                                     v.shape[3])
            self.seen.add((B, Sq, Sk, H, KV, D, Dv, mask_kind, window,
                           kv_valid_len))
            return self._orig(q, k, v, mask_kind, window, kv_valid_len)
        Ly.flash_attention = attend
        return self

    def __exit__(self, *exc):
        Ly.flash_attention = self._orig


class RouteLog:
    """Records every ``_moe_route`` call's expert choices and, computed
    here from the router's weights and the call's tokens, its router
    probabilities (on the CPU) while active."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = Ly._moe_route

        def route(p, cfg, xt):
            out = self._orig(p, cfg, xt)
            probs = torch.softmax(Ly.dense(p.router, xt).float(), dim=-1)
            self.calls.append((out[1].cpu(), probs.cpu()))
            return out
        Ly._moe_route = route
        return self

    def __exit__(self, *exc):
        Ly._moe_route = self._orig


def compare_routes(name: str, card: RouteLog, cpu: RouteLog) -> dict:
    """Each token's set of chosen experts on the card against the CPU's.
    A token whose sets differ fails the run unless the two experts it
    swaps have CPU router probabilities within ROUTE_TIE (a tie the
    devices break apart): that token is printed and counted."""
    if len(card.calls) != len(cpu.calls):
        fail(f"{name}: {len(card.calls)} routings on the card, "
             f"{len(cpu.calls)} on the CPU")
    ties, tokens = [], 0
    for call, ((ic, _), (ip, pp)) in enumerate(zip(card.calls, cpu.calls)):
        a, b = ic.sort(-1).values, ip.sort(-1).values
        tokens += a.shape[0]
        for t in torch.nonzero((a != b).any(-1)).flatten().tolist():
            only_card = sorted(set(a[t].tolist()) - set(b[t].tolist()))
            only_cpu = sorted(set(b[t].tolist()) - set(a[t].tolist()))
            gap = float((pp[t, only_card] - pp[t, only_cpu]).abs().max())
            if gap > ROUTE_TIE:
                fail(f"{name}: routing call {call} token {t} chose experts "
                     f"{only_card} on the card and {only_cpu} on the CPU, "
                     f"probability gap {gap} > {ROUTE_TIE}")
            ties.append(dict(call=call, token=t, card=only_card,
                             cpu=only_cpu, gap=gap))
            print(f"{name}: routing tie at call {call} token {t}: experts "
                  f"{only_card} (card) / {only_cpu} (CPU), probability gap "
                  f"{gap:.3g}")
    return dict(routed_tokens=tokens, calls=len(card.calls), ties=ties)


def params_to_cpu(params, cfg):
    """A CPU copy of the card's ``params``, each tensor copied through one
    pinned buffer of STAGE_BYTES (faster than the driver's own staging of
    a copy into pageable memory, which set most of (b)'s wall)."""
    out = lm_module(cfg, "cpu")
    dst = out.state_dict()
    stage = torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
    for name, src in params.state_dict().items():
        s8 = src.reshape(-1).view(torch.uint8)
        d8 = dst[name].reshape(-1).view(torch.uint8)
        for i in range(0, s8.numel(), STAGE_BYTES):
            n = min(STAGE_BYTES, s8.numel() - i)
            stage[:n].copy_(s8[i:i + n])
            d8[i:i + n].copy_(stage[:n])
    return out


def family_card_vs_cpu(arch: str, layers) -> dict:
    """(b) for one family: forward, prefill and PARITY_STEPS greedy decode
    steps on the card (kernels) and on the CPU (plain versions), float32,
    one weight set: logits and every cache leaf within LM_PARITY_TOL; for
    ``moe`` the routed experts first (``compare_routes``)."""
    t_setup = time.perf_counter()
    cfg = family_cfg(arch, layers, "float32")
    card, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = card.init(0)
    params_cpu = params_to_cpu(params, cfg)
    gen = torch.Generator().manual_seed(17)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, PARITY_PROMPT),
                                     generator=gen)}
    batch |= stub_inputs(cfg, 1, PARITY_PROMPT, gen)
    errs = {}

    def compare(what, a, b):
        e = float((a.float().cpu() - b.float()).abs().max())
        errs[what] = max(errs.get(what, 0.0), e)
        if not e <= LM_PARITY_TOL:
            fail(f"{cfg.name} card vs CPU: {what} max abs err {e} > "
                 f"{LM_PARITY_TOL}")

    setup_s = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    card_routes, cpu_routes = RouteLog(), RouteLog()
    reset_lm_counts()
    max_seq = PARITY_PROMPT + PARITY_STEPS + 1
    with card_routes:
        fwd = card.forward(params, batch)
        lg, cache = card.prefill(params, batch, card.init_cache(1, max_seq))
    with cpu_routes:
        fwd_c = cpu.forward(params_cpu, batch)
        lg_c, cache_c = cpu.prefill(params_cpu, batch,
                                    cpu.init_cache(1, max_seq))
    compare("forward logits", fwd, fwd_c)
    compare("prefill logits", lg, lg_c)
    for i in range(PARITY_STEPS):
        tok = torch.argmax(lg_c[:, -1], -1)[:, None]
        with card_routes:
            lg, cache = card.decode_step(params, tok, cache,
                                         PARITY_PROMPT + i)
        with cpu_routes:
            lg_c, cache_c = cpu.decode_step(params_cpu, tok, cache_c,
                                            PARITY_PROMPT + i)
        compare("decode logits", lg, lg_c)
        for j, (a, b) in enumerate(zip(Tr.tree_leaves(cache),
                                       Tr.tree_leaves(cache_c))):
            compare(f"cache leaf {j}", a, b)
    launches = lm_counts()
    wall = time.perf_counter() - t0
    want = expected_launches(cfg, 2, PARITY_STEPS)
    want["flash_attention_tc"] = want["flash_attention"]
    if launches != want:
        fail(f"{cfg.name} card vs CPU launched {launches}, expected {want} "
             f"(float32: the 3xTF32 attention kernels, on tensor cores)")
    routes = (compare_routes(f"{cfg.name} card vs CPU", card_routes,
                             cpu_routes) if cfg.family == "moe" else None)
    print(f"phase 16 (b) {cfg.name} card vs CPU (d {cfg.d_model}, "
          f"{cfg.n_layers} layers, float32, prompt {PARITY_PROMPT}, "
          f"{PARITY_STEPS} decode steps): max abs err {json.dumps(errs)} "
          f"(gate {LM_PARITY_TOL}); launches {launches}"
          f"{'' if routes is None else '; routed tokens ' + str(routes['routed_tokens']) + ', ties ' + str(len(routes['ties']))}"
          f"; {wall:.1f} s after {setup_s:.1f} s of set-up (init on the "
          f"card, the weights staged to the CPU)")
    del params, params_cpu, card, cpu
    free_card()
    return dict(arch=arch, layers=cfg.n_layers, max_abs_err=errs,
                gate=LM_PARITY_TOL, launches=launches, routes=routes,
                wall_s=wall, setup_s=setup_s)


def families_phase() -> dict:
    """Phase 16: (a) every family served, (b) each against the CPU."""
    t0 = time.perf_counter()
    served = [family_serve(a, n) for a, n in FAMILY_SERVE]
    t1 = time.perf_counter()
    parity = [family_card_vs_cpu(a, n) for a, n in FAMILY_PARITY]
    out = dict(serve=served, card_vs_cpu=parity, serve_s=t1 - t0,
               card_vs_cpu_s=time.perf_counter() - t1,
               wall_s=time.perf_counter() - t0)
    print(f"phase 16: {out['wall_s']:.1f} s ((a) {out['serve_s']:.1f} s, "
          f"(b) {out['card_vs_cpu_s']:.1f} s)")
    return out



# ---- 17. training on the card ---------------------------------------------
# (a) the backward kernels against their plain versions: (B, Sq, Sk, H, KV,
# D, Dv, mask, window, kv_valid_len, tag).  Hymba's training shape (the
# phase 11 request: 1024 tokens + 128 meta tokens, batch 4), internlm2's
# (one 1024-token sequence), MLA's head dims, whisper's encoder over its
# 1500 frames, a ragged kv_valid_len, and small shapes for the other head
# dim classes (16, 32) and D != Dv under a window
FA_BWD_TRAIN = (4, 1152, 1152, 25, 5, 64, 64, "window", 1024, None,
                "hymba train")
FA_BWD_SHAPES = (FA_BWD_TRAIN,
                 (1, 1024, 1024, 16, 8, 128, 128, "causal", 0, None,
                  "internlm2 train"),
                 (1, 512, 512, 16, 16, 192, 128, "causal", 0, None,
                  "MLA train"),
                 (1, 1500, 1500, 6, 6, 64, 64, "none", 0, None,
                  "whisper encoder train"),
                 (2, 200, 333, 25, 5, 64, 64, "causal", 0, 317,
                  "kv_valid_len"),
                 (1, 40, 48, 4, 2, 16, 16, "causal", 0, None, "head dim 16"),
                 (2, 96, 160, 4, 1, 16, 64, "window", 48, 150, "Dv != D"),
                 (1, 64, 64, 4, 4, 32, 32, "none", 0, None, "head dim 32"))
FA_BWD_TIMED = ("hymba train", "internlm2 train", "MLA train",
                "whisper encoder train")
# float32: the reference's gradient tolerance (tests/test_kernels.py);
# bfloat16: the tensor-core kernels against their mirror
# (flash_attention_bwd_tc_mirror: P and dS rounded to bf16 before the
# products they feed, as the kernels do) within ref.tc_bwd_agreement's
# gate: two bf16 roundings of the result plus 1e-4 of the largest
# gradient, and at most TC_BWD_MAX_PAST elements a tensor past that, each
# within one bf16 rounding (TC_BWD_PAST_OF_MAX) of the tensor's largest
# magnitude (a P or dS that the two, computing it in float32 in another
# order, round to neighbouring bf16 values)
FA_BWD_F32_TOL = 3e-5
# bfloat16 against the float32 plain version on the same (bf16-valued)
# inputs: each gradient's max abs error at most this many times that of
# the backward of scaled_dot_product_attention on the same inputs (the
# library's own rounding, measured in the same run)
FA_BWD_SDPA_FACTOR = 2.0
# the forward's log-sum-exp against the plain version's: float32 within
# the float32 forward tolerance, bf16 within ex2.approx's and the sums'
# rounding
FA_LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
# the scan backward: (B, S, Di, Ds, h0 and dhT given, tag)
MS_BWD_TRAIN = (4, 1152, 3200, 16, False, "hymba train")
MS_BWD_SHAPES = (MS_BWD_TRAIN, (1, 512, 8192, 16, True, "falcon-mamba width"),
                 (2, 37, 70, 3, True, "ragged"), (1, 5, 33, 16, False,
                                                  "ragged"),
                 (3, 77, 130, 32, True, "ragged"), (1, 1, 64, 1, True,
                                                    "one step"))
MS_BWD_TIMED = ("hymba train", "falcon-mamba width")
MS_BWD_TOL = 1e-4
FA_BWD_SOURCE = FA_SOURCES + "flash_attention_bwd_wgmma.cu"
MS_BWD_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu"
# (b) one train step at full width, 2 layers, float32, batch 1, 64 tokens:
# card against CPU.  Each parameter's gradient of the loss, before the
# optimizer, within 2e-5 of its tensor's largest magnitude plus rtol 1e-4
# (the tolerance of tests/test_torch_train.py against jax.grad).  Then one
# make_train_step on each: loss and gradient norm within 1e-4 (relative),
# and the updated weights as a second check.  AdamW's first step moves each weight by lr g / (|g| + eps) + lr wd p: where the
# gradient stands clear of the float32 noise of the two devices' sums (|g|
# at least TRAIN_GRAD_FLOOR of its tensor's largest, read from the CPU's
# first moment) the two moves agree to the weight's rounding (1e-6); where
# it does not, its direction is noise and the moves may differ by up to
# 2 lr, so those weights are held to 2 lr + 1e-6 and counted
TRAIN_PARITY_TOKENS = 64
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_ATOL_OF_MAX, TRAIN_GRAD_RTOL = 2e-5, 1e-4
TRAIN_GRAD_FLOOR = 1e-3
TRAIN_PARAM_ATOL = 1e-6
# (c) hymba-1.5b as configured, 6 steps of a batch 4 x 1024 tokens
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 1024
TRAIN_OPT = AdamWConfig(lr=3e-4, warmup_steps=2)
# (d) the fault-tolerant driver on the reduced config
FT_STEPS, FT_CKPT_EVERY, FT_FAULT_AT = 6, 2, 3


def fa_bwd_bound_ms(B, Sq, Sk, H, KV, D, Dv, mask, window, kvl,
                    dtype) -> tuple:
    """Least time for one attention backward (``flash_attention/cost.py``:
    2 (3 D + 2 Dv) operations a visible (q, k) pair and head; q, k, v, out,
    dout and lse read once and dq, dk, dv written once) at the tensor
    cores' rate for the input type and the memory rate, whichever is
    larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    ops, nbytes = fa_cost.backward_work(B, Sq, Sk, H, KV, D, Dv, mask,
                                        window, kvl, size)
    return bound_of(ops * tensor_core_op_s(dtype) * 1e3, nbytes)


def ms_bwd_bound_ms(B, S, Di, Ds, with_h0: bool,
                    sm_clock_hz: float) -> tuple:
    """Least time for one scan backward: the larger of its byte bound (u,
    delta, dy, A, Bc, Cc (h0, dhT) read once and du, ddelta, dA, dB, dC
    (dh0) written once at the memory rate; 10 FP32 operations per (b, t,
    di, n) at the FP32 rate stay below it) and its floor on the
    special-function units (the exponentials exp(delta A) the gradient
    needs, one per (b, t, di, n), at SFU_PER_SM per SM per clock at the
    max SM clock).  Returns (ms, "bytes" | "operations", byte bound ms,
    SFU floor ms)."""
    ops, nbytes = ms_cost.backward_work(B, S, Di, Ds, with_h0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t_sfu = ms_cost.exponentials(B, S, Di, Ds) / (
        SFU_PER_SM * n_sm * sm_clock_hz) * 1e3
    t_bytes = max(t_bytes, t_ops)
    if t_sfu > t_bytes:
        return t_sfu, "operations", t_bytes, t_sfu
    return t_bytes, "bytes", t_bytes, t_sfu


def sdpa_call(q, k, v, mask, w, kvl):
    """(qt, kt, vt, fn): q, k, v in SDPA's (B, H, S, D) layout, requiring
    grad, and ``fn()``: one ``scaled_dot_product_attention`` call with the
    port's mask as a boolean mask and ``enable_gqa`` (the port never calls
    it)."""
    Sq, Sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    valid = Sk if kvl is None else kvl
    qp = torch.arange(Sq, device="cuda")[:, None] + (
        valid - Sq if kvl is not None else 0)
    kp = torch.arange(Sk, device="cuda")[None, :]
    allowed = kp < valid
    if mask != "none":
        allowed = allowed & (kp <= qp)
    if mask == "window":
        allowed = allowed & (qp - kp < w)
    return qt, kt, vt, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allowed, enable_gqa=True)


def sdpa_bwd_ms(q, k, v, dout, mask, w, kvl) -> float:
    """The backward of one ``scaled_dot_product_attention`` call under
    autograd: its forward and backward timed together, its forward
    subtracted."""
    qt, kt, vt, sdpa = sdpa_call(q, k, v, mask, w, kvl)
    gt = dout.transpose(1, 2).contiguous()
    both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt), 5)
    with torch.no_grad():
        fwd = cuda_ms(sdpa, 5)
    return both - fwd


def sdpa_grads(q, k, v, dout, mask, w, kvl) -> tuple:
    """(dq, dk, dv) of ``scaled_dot_product_attention`` in the port's (B,
    S, H, D) layout, in the inputs' dtype."""
    qt, kt, vt, sdpa = sdpa_call(q, k, v, mask, w, kvl)
    gs = torch.autograd.grad(sdpa(), (qt, kt, vt),
                             dout.transpose(1, 2).contiguous())
    return tuple(g.transpose(1, 2) for g in gs)


def check_attention_bwd() -> list:
    """(a) for attention: the forward's log-sum-exp and the backward kernels
    against the plain versions (bf16: the tensor-core mirror, and the
    float32 plain version beside SDPA's backward), twice bitwise equal,
    timed."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    occupancy = {}
    for shape in FA_BWD_SHAPES:
        B, Sq, Sk, H, KV, D, Dv, mask, w, kvl, tag = shape
        for dt in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(*s, generator=gen,
                                       device="cuda").to(dt)
            q, k, v = r(B, Sq, H, D), r(B, Sk, KV, D), r(B, Sk, KV, Dv)
            dout = r(B, Sq, H, Dv)
            out, lse = fa_ops.flash_attention_fwd_lse(q, k, v, mask, w, kvl)
            torch.cuda.synchronize()
            _, lse_want = flash_attention_blocked(q, k, v, mask, w, kvl,
                                                  return_lse=True)
            seen = lse_want > NEG_INF / 2
            lse_err = float((lse - lse_want)[seen].abs().max()) \
                if bool(seen.any()) else 0.0
            if not lse_err <= FA_LSE_TOL[dt]:
                fail(f"flash_attention's log-sum-exp disagrees with its plain "
                     f"version at {shape[:-1]} {dt}: max abs err {lse_err}")
            before = fa_ops.flash_attention.launches_bwd
            got = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, mask,
                                             w, kvl)
            torch.cuda.synchronize()
            if fa_ops.flash_attention.launches_bwd != \
                    before + fa_ops.BWD_LAUNCHES:
                fail("flash_attention_bwd did not count its launches")
            if dt == torch.bfloat16:
                want = flash_attention_bwd_tc_mirror(q, k, v, out, lse, dout,
                                                     mask, w, kvl)
            else:
                want = flash_attention_bwd_blocked(q, k, v, out, lse, dout,
                                                   mask, w, kvl)
            errs, past = {}, {}
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                if dt == torch.bfloat16:
                    agr = tc_bwd_agreement(a, b)
                    errs[name] = agr["max_abs_err"]
                    past[name] = dict(elements=agr["past_two_roundings"],
                                      of_max=agr["past_of_max"])
                    ok = agr["ok"]
                else:
                    diff = (a - b).abs()
                    errs[name] = float(diff.max())
                    ok = bool((diff <= FA_BWD_F32_TOL
                               + FA_BWD_F32_TOL * b.abs()).all())
                if not ok:
                    fail(f"flash_attention_bwd disagrees with its plain "
                         f"version at {shape[:-1]} {dt}: {name} max abs err "
                         f"{errs[name]}"
                         + (f", past two roundings {json.dumps(past[name])} "
                            f"(at most {TC_BWD_MAX_PAST} elements, "
                            f"{TC_BWD_PAST_OF_MAX} of the largest)"
                            if name in past
                            else f" (tol {FA_BWD_F32_TOL})"))
            again = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, mask,
                                               w, kvl)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"flash_attention_bwd is not deterministic at "
                     f"{shape[:-1]} {dt}")
            row = dict(shape=list(shape[:-1]), tag=tag, dtype=str(dt),
                       max_abs_err=max(errs.values()), errs=errs,
                       lse_max_abs_err=lse_err)
            sdpa_text = ""
            if dt == torch.bfloat16:
                row["past_two_roundings"] = past
                sdpa_text = (f"; past two roundings (elements, largest "
                             f"difference of the tensor's largest) "
                             f"{json.dumps(past)}")
                # against the float32 plain version, beside SDPA's backward
                f32 = flash_attention_bwd_blocked(
                    q.float(), k.float(), v.float(), out.float(), lse,
                    dout.float(), mask, w, kvl)
                lib = sdpa_grads(q, k, v, dout, mask, w, kvl)
                vs32 = {}
                for name, a, s, b in zip(("dq", "dk", "dv"), got, lib, f32):
                    ours = float((a.float() - b).abs().max())
                    theirs = float((s.float() - b).abs().max())
                    vs32[name] = dict(kernel=ours, sdpa=theirs)
                    if not ours <= FA_BWD_SDPA_FACTOR * theirs:
                        fail(f"flash_attention_bwd bf16 at {shape[:-1]}: "
                             f"{name} is {ours} from the float32 plain "
                             f"version, more than {FA_BWD_SDPA_FACTOR} x "
                             f"SDPA's backward's {theirs}")
                row["vs_float32"] = vs32
                if (D, Dv) not in occupancy:
                    occupancy[(D, Dv)] = fa_ops.bwd_occupancy(D, Dv)
                row["occupancy"] = occupancy[(D, Dv)]
                sdpa_text += (
                    f"; against float32 (kernel / sdpa) "
                    + ", ".join(f"{n} {e['kernel']:.3g} / {e['sdpa']:.3g}"
                                for n, e in vs32.items())
                    + f"; blocks an SM dk/dv "
                    f"{row['occupancy']['dkdv']['blocks_per_sm']}, dq "
                    f"{row['occupancy']['dq']['blocks_per_sm']}")
            if tag in FA_BWD_TIMED:
                call = lambda: fa_ops.flash_attention_bwd(
                    q, k, v, out, lse, dout, mask, w, kvl)
                b_ms, b_by = fa_bwd_bound_ms(B, Sq, Sk, H, KV, D, Dv, mask,
                                             w, kvl, dt)
                row.update(
                    ms=cuda_ms(call, 5),
                    plain_ms=cuda_ms(lambda: flash_attention_bwd_blocked(
                        q, k, v, out, lse, dout, mask, w, kvl), 2, warmup=1),
                    library_ms=sdpa_bwd_ms(q, k, v, dout, mask, w, kvl),
                    bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            timing = (f", kernel {row['ms'] * 1e3:.1f} us, plain "
                      f"{row['plain_ms'] * 1e3:.1f} us, sdpa backward "
                      f"{row['library_ms'] * 1e3:.1f} us, bound "
                      f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})"
                      if "ms" in row else "")
            print(f"flash_attention_bwd {shape[:-1]} {tag} {dt}: max abs err "
                  f"{json.dumps(errs)} against the "
                  f"{'mirror' if dt == torch.bfloat16 else 'plain version'}"
                  f", lse {lse_err:.3g}, deterministic{sdpa_text}{timing}")
    return rows


def check_scan_bwd(sm_clock_hz: float) -> list:
    """(a) for the scan: the forward's chunk states against the plain ones,
    the backward kernel from them against the plain reverse-time version
    (1e-4), twice bitwise equal, its split of the card, timed."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = []
    for B, S, Di, Ds, with_h0, tag in MS_BWD_SHAPES:
        u, dl = r(B, S, Di), torch.nn.functional.softplus(r(B, S, Di))
        A = -torch.exp(r(Di, Ds) * 0.3)
        Bc, Cc, dy = r(B, S, Ds), r(B, S, Ds), r(B, S, Di)
        h0 = r(B, Di, Ds) if with_h0 else None
        dhT = r(B, Di, Ds) if with_h0 else None
        args = (u, dl, A, Bc, Cc, h0, dy, dhT)
        _, _, states = ms_ops.selective_scan_fwd_states(u, dl, A, Bc, Cc, h0)
        _, _, states_want = selective_scan_ref(u, dl, A, Bc, Cc, h0,
                                               return_states=True)
        st_err = float((states - states_want).abs().max())
        if not bool(((states - states_want).abs()
                     <= MS_BWD_TOL + MS_BWD_TOL * states_want.abs()).all()):
            fail(f"the scan forward's chunk states disagree with the plain "
                 f"ones at {(B, S, Di, Ds)} {tag}: max abs err {st_err}")
        before = ms_ops.selective_scan.launches_bwd
        got = ms_ops.selective_scan_bwd(*args, states)
        torch.cuda.synchronize()
        if ms_ops.selective_scan.launches_bwd != \
                before + ms_ops.BWD_LAUNCHES:
            fail("selective_scan_bwd did not count its launches")
        want = selective_scan_bwd_ref(*args)
        errs = {}
        for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dh0"), got,
                              want):
            if b is None:
                continue
            diff = (a - b).abs()
            errs[name] = float(diff.max())
            if not bool((diff <= MS_BWD_TOL + MS_BWD_TOL * b.abs()).all()):
                fail(f"selective_scan_bwd disagrees with its plain version at "
                     f"{(B, S, Di, Ds)} {tag}: {name} max abs err "
                     f"{errs[name]}")
        again = ms_ops.selective_scan_bwd(*args, states)
        if not all(a is None or torch.equal(a, b) for a, b in zip(got,
                                                                  again)):
            fail(f"selective_scan_bwd is not deterministic at "
                 f"{(B, S, Di, Ds)} {tag}")
        split = ms_ops.bwd_split(B, Di, Ds)
        row = dict(shape=[B, S, Di, Ds], tag=tag, h0=with_h0,
                   max_abs_err=max(errs.values()), errs=errs,
                   states_max_abs_err=st_err, tolerance=MS_BWD_TOL,
                   split=split, states_bytes=states.numel() * 4)
        if tag in MS_BWD_TIMED:
            b_ms, b_by, b_bytes, b_sfu = ms_bwd_bound_ms(B, S, Di, Ds,
                                                         with_h0, sm_clock_hz)
            # the training forward (writing the chunk states the backward
            # starts from) beside serving's, which writes none
            row.update(fwd_states_ms=cuda_ms(
                           lambda: ms_ops.selective_scan_fwd_states(
                               u, dl, A, Bc, Cc, h0), 5),
                       fwd_ms=cuda_ms(lambda: ms_ops.selective_scan(
                           u, dl, A, Bc, Cc, h0), 5))
            row.update(ms=cuda_ms(lambda: ms_ops.selective_scan_bwd(
                           *args, states), 5),
                       plain_ms=cuda_ms(lambda: selective_scan_bwd_ref(*args),
                                        1, warmup=0),
                       bound_ms=b_ms, bound_by=b_by, byte_bound_ms=b_bytes,
                       sfu_floor_ms=b_sfu, sm_clock_hz=sm_clock_hz,
                       library_ms=None)
        rows.append(row)
        timing = (f", kernel {row['ms'] * 1e3:.1f} us, plain "
                  f"{row['plain_ms'] * 1e3:.1f} us, bound "
                  f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}; bytes "
                  f"{row['byte_bound_ms'] * 1e3:.3f} us, exponentials "
                  f"{row['sfu_floor_ms'] * 1e3:.3f} us at "
                  f"{sm_clock_hz / 1e6:.0f} MHz); the forward with "
                  f"states {row['fwd_states_ms'] * 1e3:.1f} us, without "
                  f"{row['fwd_ms'] * 1e3:.1f} us"
                  if "ms" in row else "")
        print(f"mamba_scan_bwd {(B, S, Di, Ds)} {tag} h0/dhT={with_h0}: max "
              f"abs err {json.dumps(errs)} (tol {MS_BWD_TOL}), chunk states "
              f"{st_err:.3g} ({row['states_bytes']} bytes), deterministic; "
              f"{split['warps_per_block']} warps a block, {split['blocks']} "
              f"blocks, {split['blocks_per_sm_max_resident']} an SM at most"
              f"{timing}")
    return rows


def reset_train_counts():
    reset_lm_counts()
    fa_ops.flash_attention.launches_bwd = 0
    ms_ops.selective_scan.launches_bwd = 0


def train_counts() -> dict:
    return dict(lm_counts(),
                flash_attention_bwd=fa_ops.flash_attention.launches_bwd,
                mamba_scan_bwd=ms_ops.selective_scan.launches_bwd)


def expected_train_counts(cfg, steps: int) -> dict:
    """The launches of ``steps`` hybrid train steps under remat: each layer's
    attention and scan forward run twice (the forward and its
    recomputation in the backward) and backward once (three kernels for
    attention, two for the scan); attention on the tensor cores in both
    dtypes."""
    L = cfg.n_layers
    return dict(flash_attention=2 * L * steps,
                flash_attention_tc=2 * L * steps,
                mamba_scan=2 * L * steps,
                flash_attention_bwd=fa_ops.BWD_LAUNCHES * L * steps,
                mamba_scan_bwd=ms_ops.BWD_LAUNCHES * L * steps)


def loss_grads(model, params, batch) -> dict:
    """Each parameter's gradient of ``model.loss`` on ``batch`` (zeros
    where the loss does not reach it)."""
    names, ps = zip(*params.named_parameters())
    loss, _ = model.loss(params, batch)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, ps, gs)}


def grads_card_vs_cpu(card, cpu, params, params_cpu, batch) -> dict:
    """(b)'s gradient check: the card's gradients against the CPU's, tensor
    by tensor, at 2e-5 of the CPU tensor's largest magnitude plus rtol
    1e-4."""
    got = loss_grads(card, params, batch)
    want = loss_grads(cpu, params_cpu, batch)
    worst, name_worst = 0.0, None
    for n, b in want.items():
        a = got[n].cpu()
        scale = float(b.abs().max())
        diff = (a - b).abs()
        if not bool((diff <= TRAIN_GRAD_ATOL_OF_MAX * scale
                     + TRAIN_GRAD_RTOL * b.abs()).all()):
            fail(f"hymba train step card vs CPU: the gradient of {n} "
                 f"differs by {float(diff.max())} (its largest magnitude "
                 f"{scale}; gate {TRAIN_GRAD_ATOL_OF_MAX} of it + rtol "
                 f"{TRAIN_GRAD_RTOL})")
        rel = float(diff.max()) / scale if scale > 0 else float(diff.max())
        if rel >= worst:
            worst, name_worst = rel, n
    return dict(grad_worst_of_max=worst, grad_worst=name_worst,
                grad_tensors=len(want))


def train_card_vs_cpu() -> dict:
    """(b): Hymba at full width and 2 layers, float32, on the card
    (kernels) and on the CPU (plain versions), from one seeded state: the
    gradients of the loss, then one make_train_step."""
    cfg = dataclasses.replace(get_config(HYMBA), n_layers=2, dtype="float32")
    card, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2)
    st = make_train_state(card, 0, opt)
    params_cpu = lm_module(cfg, "cpu")
    params_cpu.load_state_dict(st["params"].state_dict())
    params_cpu.requires_grad_(True)
    st_cpu = {"params": params_cpu, "opt": adamw_init(opt, params_cpu)}
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_PARITY_TOKENS,
                                   global_batch=1)).batch_at(0)
    t0 = time.perf_counter()
    grads = grads_card_vs_cpu(card, cpu, st["params"], params_cpu, batch)
    reset_train_counts()
    _, m = make_train_step(card, opt)(st, batch)
    torch.cuda.synchronize()
    launches = train_counts()
    _, m_cpu = make_train_step(cpu, opt)(st_cpu, batch)
    want = expected_train_counts(cfg, 1)
    if launches != want:
        fail(f"hymba train step on the card launched {launches}, expected "
             f"{want}")
    loss, loss_cpu = float(m["loss"]), float(m_cpu["loss"])
    gn, gn_cpu = float(m["grad_norm"]), float(m_cpu["grad_norm"])
    for name, a, b in (("loss", loss, loss_cpu), ("grad norm", gn, gn_cpu)):
        if not abs(a - b) <= TRAIN_LOSS_RTOL * abs(b):
            fail(f"hymba train step card vs CPU: {name} {a} against {b}")
    lr = float(m["lr"])
    worst, name_worst, noise, noise_worst = 0.0, None, 0, 0.0
    for (n, a), b in zip(st["params"].named_parameters(),
                         st_cpu["params"].parameters()):
        d = (a.detach().cpu() - b.detach()).abs()
        mu = st_cpu["opt"]["mu"][n].float().abs()
        clear = mu >= TRAIN_GRAD_FLOOR * float(mu.max())
        noise += int((~clear).sum())
        if bool((~clear).any()):
            noise_worst = max(noise_worst, float(d[~clear].max()))
        if bool(clear.any()) and float(d[clear].max()) > worst:
            worst, name_worst = float(d[clear].max()), n
    if not worst <= TRAIN_PARAM_ATOL:
        fail(f"hymba train step card vs CPU: parameter {name_worst} differs "
             f"by {worst} > {TRAIN_PARAM_ATOL} where its gradient is clear "
             f"of the noise")
    if not noise_worst <= 2 * lr + TRAIN_PARAM_ATOL:
        fail(f"hymba train step card vs CPU: a weight with a noise-level "
             f"gradient moved {noise_worst} apart, more than 2 lr")
    out = dict(loss=loss, loss_cpu=loss_cpu, grad_norm=gn,
               grad_norm_cpu=gn_cpu, **grads, param_max_abs_err=worst,
               param_worst=name_worst, param_atol=TRAIN_PARAM_ATOL,
               noise_level_weights=noise, noise_level_max_abs_err=noise_worst,
               lr=lr, launches=launches, wall_s=time.perf_counter() - t0)
    print(f"hymba train step card vs CPU (d {cfg.d_model}, {cfg.n_layers} "
          f"layers, float32, {TRAIN_PARITY_TOKENS} tokens + {cfg.meta_tokens} "
          f"meta): loss {loss:.7f} / {loss_cpu:.7f}, grad norm {gn:.6f} / "
          f"{gn_cpu:.6f}; {grads['grad_tensors']} gradients within "
          f"{grads['grad_worst_of_max']:.3g} of their largest magnitude "
          f"({grads['grad_worst']}; gate {TRAIN_GRAD_ATOL_OF_MAX} + rtol "
          f"{TRAIN_GRAD_RTOL}); weights with a clear gradient within "
          f"{worst:.3g} "
          f"({name_worst}; gate {TRAIN_PARAM_ATOL}), the {noise} with a "
          f"noise-level one within {noise_worst:.3g} (gate 2 lr = "
          f"{2 * lr:.3g}); card launches {launches}; "
          f"{out['wall_s']:.1f} s")
    return out


def hymba_train() -> dict:
    """(c): hymba-1.5b as configured, 6 steps through ``train_loop``."""
    cfg = get_config(HYMBA)
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, 0, TRAIN_OPT)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    step = make_train_step(model, TRAIN_OPT)
    walls, prof = [], {}

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(walls) == TRAIN_STEPS - 1:      # the last step, profiled
            out = []
            s, n, by = device_by_kernel(
                lambda: out.append(step(state, batch)), host=False)
            prof.update(device_s=s, kernels=n, split=kernel_split(by, s))
            result = out[0]
        else:
            result = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return result

    reset_train_counts()
    res, state = train_loop(model, state, data.stream(0, TRAIN_STEPS), timed,
                            log_every=0)
    launches = train_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_counts(cfg, TRAIN_STEPS)
    if launches != want:
        fail(f"hymba-1.5b training launched {launches}, expected {want}")
    if not all(np.isfinite(res.losses)):
        fail(f"hymba-1.5b training: non-finite loss {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"hymba-1.5b training: loss did not fall {res.losses}")
    # the optimizer alone, on zero gradients (its time does not depend on
    # the values)
    params = state["params"]
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adamw_update(TRAIN_OPT, grads, state["opt"], params)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    del grads
    rest = walls[1:-1]
    step_s = sum(rest) / len(rest)
    out = dict(params=sum(p.numel() for p in params.parameters()),
               losses=res.losses, walls_s=walls, first_step_s=walls[0],
               step_s=step_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               optimizer_s=opt_s, optimizer_share=opt_s / step_s,
               peak_bytes=peak, launches=launches,
               launches_per_step={k: v // TRAIN_STEPS
                                  for k, v in launches.items()},
               profiled_step=prof)
    print(f"hymba-1.5b training ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"bf16 activations, remat {cfg.remat}, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} + {cfg.meta_tokens} meta, {out['params']} "
          f"parameters): losses {[round(x, 4) for x in res.losses]}; step "
          f"walls {[round(x, 4) for x in walls]} s (first {walls[0]:.3f} s, "
          f"steps 2-{TRAIN_STEPS - 1} mean {step_s:.4f} s; the last is "
          f"profiled), {out['tokens_per_s']:.1f} tokens/s, optimizer "
          f"{opt_s * 1e3:.1f} ms = {out['optimizer_share']:.1%} of a step, "
          f"peak device memory {peak / 2**30:.3f} GiB; launches a step "
          f"{out['launches_per_step']}")
    print(f"hymba-1.5b training: losses {json.dumps(res.losses)}")
    if prof.get("device_s"):
        sp = prof["split"]
        print(f"hymba-1.5b training: one step under the profiler "
              f"{prof['device_s'] * 1e3:.2f} ms device time, "
              f"{prof['kernels']} kernels; the attention backward "
              f"{sp['flash_attention_bwd']['s'] * 1e3:.2f} ms "
              f"({sp['flash_attention_bwd']['share']:.1%}, "
              f"{sp['flash_attention_bwd']['count']} launches), the scan "
              f"backward {sp['mamba_scan_bwd']['s'] * 1e3:.2f} ms "
              f"({sp['mamba_scan_bwd']['share']:.1%}, "
              f"{sp['mamba_scan_bwd']['count']} launches); split "
              f"{json.dumps(sp)}")
    else:
        print("hymba-1.5b training: device time not measured (the profiler "
              "saw no device events)")
    return out


def fault_tolerant_train() -> dict:
    """(d): FaultTolerantTrainer on the reduced Hymba on the card: a
    transient fault at step 3, then a second trainer resuming from the
    directory, its first loss bit for bit that of the first trainer's state
    continued."""
    cfg = get_reduced(HYMBA)
    model = build_model(cfg, "cuda")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2))
    step = make_train_step(model, opt)
    boom = {FT_FAULT_AT}

    def fault(s):
        if s in boom:
            boom.clear()
            raise TransientError("injected")

    with tempfile.TemporaryDirectory() as d:
        tr1 = FaultTolerantTrainer(step, CheckpointManager(d),
                                   ckpt_every=FT_CKPT_EVERY, fault_hook=fault)
        rep1, st1 = tr1.run(make_train_state(model, 0, opt), data.batch_at,
                            num_steps=FT_STEPS)
        if rep1.restarts != 1 or rep1.end_step != FT_STEPS:
            fail(f"fault-tolerant training: restarts {rep1.restarts}, end "
                 f"{rep1.end_step}")
        tr2 = FaultTolerantTrainer(step, CheckpointManager(d),
                                   ckpt_every=FT_CKPT_EVERY)
        rep2, _ = tr2.run(make_train_state(model, 1, opt), data.batch_at,
                          num_steps=2)
        if rep2.start_step != FT_STEPS:
            fail(f"the second trainer started at {rep2.start_step}, not "
                 f"{FT_STEPS}")
        _, m = step(st1, data.batch_at(FT_STEPS))
        cont = float(m["loss"])
    if rep2.losses[0] != cont:
        fail(f"the resumed loss {rep2.losses[0]!r} differs from the "
             f"continued run's {cont!r}")
    out = dict(losses=rep1.losses, restarts=rep1.restarts,
               resumed_losses=rep2.losses, continued_loss=cont,
               wall_s=rep1.wall_s + rep2.wall_s)
    print(f"fault-tolerant training ({cfg.name}, card): losses "
          f"{[round(x, 4) for x in rep1.losses]}, restarts {rep1.restarts}, "
          f"resumed at step {rep2.start_step} with loss {rep2.losses[0]!r} = "
          f"the continued run's, bit for bit")
    return out


def train_phase(sm_clock_hz: float) -> dict:
    """Phase 17: (a) the backward kernels, (b) a train step card vs CPU,
    (c) hymba-1.5b trained for 6 steps, (d) the fault-tolerant driver."""
    t0 = time.perf_counter()
    fa_rows = check_attention_bwd()
    ms_rows = check_scan_bwd(sm_clock_hz)
    t1 = time.perf_counter()
    parity = train_card_vs_cpu()
    free_card()
    t2 = time.perf_counter()
    trained = hymba_train()
    free_card()
    t3 = time.perf_counter()
    ft = fault_tolerant_train()
    out = dict(fa_bwd=fa_rows, ms_bwd=ms_rows, card_vs_cpu=parity,
               train=trained, fault_tolerant=ft,
               seconds=dict(kernels=t1 - t0, card_vs_cpu=t2 - t1,
                            train=t3 - t2, fault_tolerant=time.perf_counter()
                            - t3, total=time.perf_counter() - t0))
    print(f"phase 17: {json.dumps(out['seconds'])}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the front door's tail and the planning layer on the card
# ---------------------------------------------------------------------------
# the reference shim test's small problem (tests/test_api_shims.py)
SHIM_SPACE_KW = dict(max_shape=(16, 16, 4, 4, 1, 2))
SHIM_OBJ = ("latency_ns", "cost_usd")
SHIM_KEY = 3
SHIM_SA = SAConfig(steps=4, chains=2)
SHIM_ITERS = dict(n_init=2, n_iter=2)
SHIM_NSGA = NSGAConfig(pop=8, generations=2)
MONO_RTOL = 1e-6
# phase 11's first generation (tokens, last logits) on the tree before the
# kernels became custom operators (``generation_digest``; H100 80GB HBM3)
HYMBA_SERVE_DIGEST = ("eaf7cb7fba82053a878b9e1ffa63fbb9"
                      "02ff76ec68202884fb91ddb764b917a2")
# (d) the advisor's cell
PLAN_ARCH, PLAN_SHAPE, PLAN_CHIPS, PLAN_BUDGET = "qwen2-72b", "train_4k", \
    256, 32


def legacy_warnings(rec) -> int:
    return sum(1 for w in rec if issubclass(w.category, DeprecationWarning)
               and str(w.message).startswith("legacy entry point"))


def warned_once(fn):
    """(``fn()``, the legacy deprecation warnings it raised)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, legacy_warnings(rec)


def same_search_result(a, b) -> bool:
    return (a.objective == b.objective and a.history == b.history
            and all(torch.equal(a.design[k], b.design[k]) for k in a.design)
            and all(np.array_equal(np.asarray(a.metrics[k]),
                                   np.asarray(b.metrics[k]))
                    for k in a.metrics))


def same_explore_result(a, b) -> bool:
    return (np.array_equal(a.front_objs, b.front_objs)
            and np.array_equal(a.front_metrics, b.front_metrics)
            and a.n_evals_run == b.n_evals_run and a.cache_key == b.cache_key
            and all(np.array_equal(x[k], y[k]) for x, y in
                    zip(a.front_designs, b.front_designs) for k in x))


def shims_on_card(device: str = "cuda") -> dict:
    """(a): each deprecated entry point warns once and equals the
    ``Session.submit`` it routes through, bit for bit; ``monolithic_cost``
    on the card against the CPU."""
    graph = WorkloadGraph([matmul("mm", 512, 512, 64)], [])
    spec = SystemSpec.build(graph, ch_max=2)
    space = DesignSpace(spec, **SHIM_SPACE_KW)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(weights=(1.0, 1.0, 0.0, 0.0), bo_fields=(), sa=SHIM_SA,
                  **SHIM_ITERS)
        legacy, n = warned_once(lambda: legacy_optimize(
            spec, space, SHIM_KEY, device=device, **kw))
        new = Session(cache_dir=Path(tmp) / "b", device=device).submit(
            Query(Problem.from_spec(spec, space), engine="bo_sa",
                  weights=kw["weights"], engine_opts=dict(
                      bo_fields=(), sa=SHIM_SA, **SHIM_ITERS)),
            key=SHIM_KEY)
        out["optimize"] = dict(warnings=n, identical=same_search_result(
            legacy, new.raw), objective=legacy.objective)
        legacy, n = warned_once(lambda: legacy_two_stage(
            spec, space, SHIM_KEY, n_candidates=2, sa=SHIM_SA,
            device=device))
        new = Session(cache_dir=Path(tmp) / "c", device=device).submit(
            Query(Problem.from_spec(spec, space), engine="two_stage",
                  engine_opts=dict(n_candidates=2, sa=SHIM_SA)),
            key=SHIM_KEY)
        out["two_stage_optimize"] = dict(
            warnings=n, identical=same_search_result(legacy, new.raw),
            objective=legacy.objective)

        def svc(sub):
            return ExplorationService(
                cache_dir=Path(tmp) / sub, nsga=SHIM_NSGA,
                policy=BudgetPolicy(adaptive=False), device=device)
        legacy, n = warned_once(lambda: legacy_explore(
            graph, SHIM_OBJ, budget=16, ch_max=2,
            space_kwargs=SHIM_SPACE_KW, service=svc("d"), key=SHIM_KEY))
        new = Session(service=svc("e")).submit(
            Query(Problem(graph, SHIM_OBJ, 2, SHIM_SPACE_KW), budget=16,
                  engine="nsga"), key=SHIM_KEY)
        out["explore"] = dict(warnings=n, identical=same_explore_result(
            legacy, new.raw), evals=legacy.n_evals_run)
    for name, r in out.items():
        if r["warnings"] != 1 or not r["identical"]:
            fail(f"phase 18 (a) {name}: {r}")
    areas = torch.linspace(1.0, 1200.0, 4096, dtype=torch.float32)
    for tag, tech in (("default", DEFAULT_TECH),
                      ("dear wafers", dataclasses.replace(
                          DEFAULT_TECH, wafer_cost=2 * DEFAULT_TECH.wafer_cost,
                          defect_density_mm2=3e-3))):
        card = monolithic_cost(areas.to(device), tech).cpu()
        cpu = monolithic_cost(areas, tech)
        rel = float(((card - cpu).abs() / cpu.abs()).max())
        out[f"monolithic_cost {tag}"] = dict(
            max_rel=rel, bitwise=bool(torch.equal(card, cpu)))
        if not rel <= MONO_RTOL:
            fail(f"phase 18 (a) monolithic_cost {tag}: card against CPU "
                 f"{rel:.3e} past {MONO_RTOL}")
    print(f"phase 18 (a) shims: {json.dumps(out)}")
    return out


def analysis_against_training(trained: dict, device: str = "cuda") -> dict:
    """(c), training: phase 17 (c)'s step traced on fake CUDA tensors,
    against what the card measured."""
    cfg = get_config(HYMBA)
    model = build_model(cfg, device)
    before = train_counts()
    batch = batch_specs(cfg, TRAIN_BATCH, TRAIN_SEQ, with_labels=True)
    batch["loss_mask"] = sds((TRAIN_BATCH, TRAIN_SEQ), torch.float32)
    t0 = time.perf_counter()
    an = analyze(make_train_step(model, TRAIN_OPT),
                 train_state_specs(model, TRAIN_OPT), batch, device=device)
    trace_s = time.perf_counter() - t0
    if train_counts() != before:
        fail(f"phase 18 (c): the trace launched kernels: {before} -> "
             f"{train_counts()}")
    k = an.kernels

    def launches(*ops):
        return sum(k.get(f"repro_torch::{o}", {}).get("launches", 0)
                   for o in ops)
    traced = dict(flash_attention=launches("flash_attention",
                                           "flash_attention_fwd_lse"),
                  mamba_scan=launches("selective_scan",
                                      "selective_scan_fwd_states"),
                  flash_attention_bwd=launches("flash_attention_bwd"),
                  mamba_scan_bwd=launches("selective_scan_bwd"))
    per_step = trained["launches_per_step"]
    counted = {n: per_step[n] for n in traced}
    if traced != counted:
        fail(f"phase 18 (c): traced launches {traced}, phase 17 (c) "
             f"counted {counted} a step")
    prof = trained["profiled_step"]
    profiled = None
    if prof.get("split"):
        sp = prof["split"]
        profiled = dict(flash_attention=sp["flash_attention_tc"]["count"],
                        mamba_scan=sp["mamba_scan"]["count"],
                        flash_attention_bwd=sp["flash_attention_bwd"]["count"],
                        mamba_scan_bwd=sp["mamba_scan_bwd"]["count"])
        if traced != profiled:
            fail(f"phase 18 (c): traced launches {traced}, the profiled "
                 f"step {profiled}")
    sc = ShapeConfig("hymba train", TRAIN_SEQ, TRAIN_BATCH, "train")
    mflops = model_flops_for(cfg, sc)
    peak = DEFAULT_H100.peak_bf16_tflops * 1e12
    out = dict(trace_s=trace_s, traced_launches=traced,
               profiled_launches=profiled, counted_flops=an.flops,
               kernel_flops=an.flops_kernels, bytes_all=an.bytes_all,
               bytes_heavy=an.bytes_heavy, peak_bytes=an.peak_bytes,
               input_bytes=an.input_bytes, ops=an.ops,
               measured_peak_bytes=trained["peak_bytes"],
               peak_gap_bytes=trained["peak_bytes"] - an.peak_bytes,
               model_flops=mflops, step_wall_s=trained["step_s"],
               model_share_of_wall=mflops / (trained["step_s"] * peak))
    if prof.get("device_s"):
        out.update(device_s=prof["device_s"],
                   model_share_of_device=mflops / (prof["device_s"] * peak),
                   counted_share_of_device=an.flops / (prof["device_s"]
                                                       * peak))
    rl = roofline(an.flops, an.bytes_all, an.total_wire_bytes, 1, mflops)
    out["roofline"] = rl.to_dict()
    print(f"phase 18 (c) train step traced in {trace_s:.2f} s on fake CUDA "
          f"tensors ({an.ops} operators, no kernel launched): kernel launches "
          f"{traced} = phase 17 (c)'s {counted} a step (profiled step "
          f"{profiled}); traced peak {an.peak_bytes / 2**30:.3f} GiB "
          f"(inputs {an.input_bytes / 2**30:.3f}) against "
          f"max_memory_allocated {trained['peak_bytes'] / 2**30:.3f} GiB, "
          f"gap {out['peak_gap_bytes'] / 2**30:+.3f} GiB; model FLOPs "
          f"{mflops:.4e} (6 N D), counted {an.flops:.4e} (kernels "
          f"{an.flops_kernels:.4e}); share of the bf16 peak "
          f"{DEFAULT_H100.peak_bf16_tflops} TFLOP/s: "
          + (f"{out['model_share_of_device']:.2%} of the profiled step's "
             f"{prof['device_s'] * 1e3:.2f} ms of device time, "
             if prof.get("device_s") else "device time not measured, ")
          + f"{out['model_share_of_wall']:.2%} of the "
          f"{trained['step_s'] * 1e3:.1f} ms step wall; bytes all "
          f"{an.bytes_all:.4e}, heavy {an.bytes_heavy:.4e}; roofline "
          f"{rl.bottleneck} {rl.step_time_s * 1e3:.2f} ms", flush=True)
    return out


def analysis_against_decode(served: dict, device: str = "cuda") -> dict:
    """(c), decode: one decode step of phase 11 traced on fake CUDA
    tensors; its compulsory bytes at the HBM rate against the decode
    step's device time."""
    cfg = get_config(HYMBA)
    model = build_model(cfg, device)
    base = SERVE_PROMPT + cfg.meta_tokens
    cache = cache_specs(cfg, SERVE_BATCH, base + SERVE_TOKENS + 1)
    before = lm_counts()
    t0 = time.perf_counter()
    an = analyze(lambda p, tok, c: model.decode_step(p, tok, c, base),
                 params_specs(cfg), sds((SERVE_BATCH, 1), torch.int64),
                 cache, device=device)
    trace_s = time.perf_counter() - t0
    if lm_counts() != before:
        fail(f"phase 18 (c) decode: the trace launched kernels")
    scans = an.kernels.get("repro_torch::selective_scan", {}).get(
        "launches", 0)
    if scans != cfg.n_layers:
        fail(f"phase 18 (c) decode: traced {scans} scan launches, expected "
             f"{cfg.n_layers}")
    sc = ShapeConfig("hymba decode", base, SERVE_BATCH, "decode")
    min_bytes = model_min_bytes_for(cfg, sc, {"cache": cache})
    floor_s = min_bytes / (DEFAULT_H100.hbm_gbps * 1e9)
    out = dict(trace_s=trace_s, ops=an.ops, scan_launches=scans,
               counted_flops=an.flops, bytes_all=an.bytes_all,
               min_bytes=min_bytes, min_bytes_s=floor_s,
               step_wall_s=served["decode_step_s"])
    dev_s = served.get("decode_step_device_s")
    if dev_s:
        out.update(device_s=dev_s, floor_share_of_device=floor_s / dev_s)
    print(f"phase 18 (c) decode step traced in {trace_s:.2f} s ({an.ops} "
          f"operators, {scans} scan launches, bytes all {an.bytes_all:.4e}):"
          f" compulsory bytes {min_bytes:.4e} at "
          f"{DEFAULT_H100.hbm_gbps} GB/s = {floor_s * 1e3:.3f} ms against "
          + (f"{dev_s * 1e3:.3f} ms of device time ("
             f"{out['floor_share_of_device']:.2%})" if dev_s
             else "device time not measured")
          + f" and {served['decode_step_s'] * 1e3:.3f} ms of wall",
          flush=True)
    return out


def advisor_on_card(device: str = "cuda") -> dict:
    """(d): ``bo_search`` with the GP on the card beside
    ``exhaustive_best``."""
    cfg, sc = get_config(PLAN_ARCH), SHAPES[PLAN_SHAPE]
    before = gp_ops.matern52.launches
    t0 = time.perf_counter()
    plan, score, n_evals, _ = bo_search(cfg, sc, chips=PLAN_CHIPS,
                                        budget=PLAN_BUDGET, device=device)
    sync_of(device)()
    bo_s = time.perf_counter() - t0
    launches = gp_ops.matern52.launches - before
    # two covariances a BO iteration on the card (none on the CPU)
    want = 2 * (PLAN_BUDGET - 8) if device == "cuda" else 0
    if launches != want:
        fail(f"phase 18 (d): bo_search launched gp_cov {launches} times, "
             f"expected {want}")
    best, best_score, scored = exhaustive_best(cfg, sc, chips=PLAN_CHIPS)
    out = dict(bo_plan=dataclasses.asdict(plan), bo_step_s=score.step_s,
               bo_feasible=score.feasible, evaluations=n_evals,
               gp_cov_launches=launches, bo_wall_s=bo_s,
               exhaustive_plan=dataclasses.asdict(best),
               exhaustive_step_s=best_score.step_s, plans=len(scored))
    print(f"phase 18 (d) advisor {PLAN_ARCH} {PLAN_SHAPE} on {PLAN_CHIPS} "
          f"cards: bo_search {n_evals} evaluations in {bo_s:.2f} s, "
          f"{launches} gp_cov launches, best step {score.step_s:.6f} s "
          f"({plan}); exhaustive_best over {len(scored)} plans "
          f"{best_score.step_s:.6f} s ({best})", flush=True)
    return out


def planning_phase(served: dict, trained: dict) -> dict:
    t0 = time.perf_counter()
    out = dict(shims=shims_on_card())
    digest = served["digest"]
    if digest != HYMBA_SERVE_DIGEST:
        fail(f"phase 18 (b): phase 11's generation digest {digest}, "
             f"recorded {HYMBA_SERVE_DIGEST}")
    print(f"phase 18 (b) phase 11's first generation bit for bit the "
          f"recorded one: {digest}")
    out["train_analysis"] = analysis_against_training(trained)
    out["decode_analysis"] = analysis_against_decode(served)
    out["advisor"] = advisor_on_card()
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 18: {out['wall_s']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase 19: the multi-rank half on one card
# ---------------------------------------------------------------------------
ISLANDS = 4
# the dry-run cell: qwen2-72b train_4k unrolls ~1k operators a layer a
# microbatch (80 layers x 8 microbatches), far past the phase's minute;
# its decode cell traces every layer once
DRY_ARCH, DRY_SHAPE = "qwen2_72b", "decode_32k"


def same_front_bits(a, b) -> bool:
    """Two results' fronts (objectives and designs) bit for bit."""
    return (np.array_equal(a.front_objs, b.front_objs)
            and len(a.front_designs) == len(b.front_designs)
            and all(np.array_equal(x[k], y[k]) for x, y in
                    zip(a.front_designs, b.front_designs) for k in x))


def islands_on_card(problem, cold, cold_s: float, cold_launches: int,
                    device: str = "cuda", budget: int = 2048) -> dict:
    """(a): phase 5's query as 4 islands of 16 on the card, beside phase
    5's plain run; a 1-island mesh equals the plain run bit for bit; the
    island count changes the checkpoint signature."""
    query = Query(problem, budget=budget)
    sync = sync_of(device)
    with tempfile.TemporaryDirectory() as cache:
        pareto_ops.dominance_counts.launches = 0
        sync()
        t0 = time.perf_counter()
        r = Session(cache_dir=cache, device=device,
                    mesh=make_island_mesh(ISLANDS, (device,))).submit(query)
        sync()
        wall = time.perf_counter() - t0
        launches = pareto_ops.dominance_counts.launches
    pv = r.provenance
    if pv.n_evals_run != cold.provenance.n_evals_run:
        fail(f"phase 19 (a): the island run spent {pv.n_evals_run} "
             f"evaluations, phase 5's {cold.provenance.n_evals_run}")
    if device == "cuda":
        check_front(problem, r)
    hv, hv_plain = front_hv(r.front_objs), front_hv(cold.front_objs)
    with tempfile.TemporaryDirectory() as cache:
        one = Session(cache_dir=cache, device=device,
                      mesh=make_island_mesh(1, (device,))).submit(query)
    if not same_front_bits(one, cold):
        fail("phase 19 (a): a 1-island mesh differs from phase 5's plain "
             "run")
    with tempfile.TemporaryDirectory() as cache:
        svc = ExplorationService(cache_dir=cache, device=device)
        args = (problem.objectives, budget, 64, 32, 8, 0, None)
        plain = svc._ckpt_signature(*args)
        svc.mesh = make_island_mesh(ISLANDS, (device,))
        four = svc._ckpt_signature(*args)
    if four == plain:
        fail("phase 19 (a): the island count left the checkpoint "
             "signature unchanged")
    out = dict(wall_s=wall, evals=pv.n_evals_run, evals_per_s=pv.n_evals_run
               / wall, plain_evals_per_s=cold.provenance.n_evals_run / cold_s,
               launches=launches, plain_launches=cold_launches, hv=hv,
               hv_plain=hv_plain, front=int(len(r.front_objs)),
               one_island_bitwise=True, signature_changes=True)
    print(f"phase 19 (a) {ISLANDS} islands of 16 on {device}: "
          f"{pv.n_evals_run} evaluations in {wall:.3f} s "
          f"({out['evals_per_s']:.1f} evaluations/s against phase 5's "
          f"{out['plain_evals_per_s']:.1f}), pareto_rank launches "
          f"{launches} (phase 5: {cold_launches}), front {out['front']} "
          f"points, hypervolume {hv:.6f} (phase 5: {hv_plain:.6f}); a "
          f"1-island mesh equals phase 5 bit for bit; the signature "
          f"{plain} becomes {four}", flush=True)
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_serve_and_restore(served: dict, device: str = "cuda",
                              cfg=None, prompt_len: int = SERVE_PROMPT,
                              n_new: int = SERVE_TOKENS) -> dict:
    """(b) phase 11's Hymba generation with DTensor parameters on a
    one-rank (1, 1) ("data", "model") mesh, through the kernels' sharding
    rules: the same tokens and logits, bit for bit, and the same launches;
    (c) a DTensor train state saved from that mesh, restored into plain
    tensors and into DTensors again, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device(device)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = DeviceMesh(dev.type, torch.zeros(1, 1, dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        pc = ParallelConfig()
        rules = Sh.make_rules(pc)
        cfg = cfg or get_config(HYMBA)
        model = build_model(cfg, device)
        params = Sh.distribute_module(model.init(0), cfg, mesh, rules)
        prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, prompt_len),
                               generator=torch.Generator().manual_seed(11))
        fa_ops.flash_attention.launches = 0
        fa_ops.flash_attention.launches_tc = 0
        ms_ops.selective_scan.launches = 0
        sync_of(device)()
        t0 = time.perf_counter()
        with activation_sharding(mesh, pc):
            gen = generate(model, params, prompt, n_new)
        sync_of(device)()
        wall = time.perf_counter() - t0
        launches = dict(flash_attention=fa_ops.flash_attention.launches,
                        flash_attention_tc=fa_ops.flash_attention.launches_tc,
                        mamba_scan=ms_ops.selective_scan.launches)
        whole = SimpleNamespace(tokens=gen.tokens.full_tensor(),
                                logits=gen.logits.full_tensor())
        digest = generation_digest(whole)
        if digest != served["digest"]:
            fail(f"phase 19 (b): the sharded generation's digest {digest}, "
                 f"phase 11's {served['digest']}")
        if launches != served["launches"]:
            fail(f"phase 19 (b): the sharded generation launched "
                 f"{launches}, phase 11 {served['launches']}")
        print(f"phase 19 (b) {cfg.name} on a one-rank (1, 1) mesh, DTensor "
              f"parameters ({sum(type(p.data).__name__ == 'DTensor' for p in params.parameters())} "
              f"of {len(list(params.parameters()))}): {n_new} tokens in "
              f"{wall:.2f} s (phase 11's run 1: "
              f"{served['runs'][0]['prefill_s'] + served['runs'][0]['decode_s']:.2f} s),"
              f" launches {launches}, tokens and logits bit for bit phase "
              f"11's ({digest})", flush=True)
        out = dict(wall_s=wall, launches=launches, digest=digest)
        del params, gen, whole
        if dev.type == "cuda":
            free_card()
        out["restore"] = elastic_on_card(mesh, rules, device)
    finally:
        dist.destroy_process_group()
    return out


def elastic_on_card(mesh, rules, device: str) -> dict:
    """(c): reduced Hymba's DTensor train state, one train step in."""
    cfg = get_reduced(HYMBA)
    model = build_model(cfg, device)
    params = model.init(5)
    params.requires_grad_(True)
    opt_cfg = AdamWConfig()
    state = {"params": Sh.distribute_module(params, cfg, mesh, rules),
             "opt": None}
    state["opt"] = adamw_init(opt_cfg, state["params"])
    tokens = torch.randint(0, cfg.vocab, (2, 16), device=device,
                           generator=torch.Generator(device).manual_seed(5))
    pc = ParallelConfig()
    with activation_sharding(mesh, pc):
        make_train_step(model, opt_cfg)(state, {"tokens": tokens})
    want = {n: p.detach().full_tensor().clone()
            for n, p in state["params"].named_parameters()}
    mu = {n: m.full_tensor().clone() for n, m in state["opt"]["mu"].items()}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        CheckpointManager(d).save(1, state, blocking=True)
        save_s = time.perf_counter() - t0
        plain_p = lm_module(cfg, device)
        plain = {"params": plain_p, "opt": adamw_init(opt_cfg, plain_p)}
        CheckpointManager(d).restore(1, plain)
        back_p = Sh.distribute_module(lm_module(cfg, device), cfg, mesh,
                                      rules)
        back = {"params": back_p, "opt": adamw_init(opt_cfg, back_p)}
        CheckpointManager(d).restore(1, back)
    for n, p in plain["params"].named_parameters():
        if not torch.equal(p, want[n]):
            fail(f"phase 19 (c): {n} restored into a plain tensor differs")
    for n, p in back["params"].named_parameters():
        if not torch.equal(p.to_local(), want[n]):
            fail(f"phase 19 (c): {n} restored into a DTensor differs")
    for n, m in plain["opt"]["mu"].items():
        if not torch.equal(m, mu[n]) or not torch.equal(
                back["opt"]["mu"][n].to_local(), mu[n]):
            fail(f"phase 19 (c): the moment of {n} differs after restore")
    if int(plain["opt"]["step"]) != int(state["opt"]["step"]) != 0:
        fail("phase 19 (c): the step count differs after restore")
    print(f"phase 19 (c) {cfg.name}'s DTensor train state after a "
          f"step ({len(want)} parameters, 2 moments, step "
          f"{int(state['opt']['step'])}) saved in {save_s:.2f} s, restored "
          f"into plain tensors and into DTensors bit for bit", flush=True)
    return dict(save_s=save_s, leaves=len(want))


def dryrun_cell_on_card(device: str = "cuda", arch: str = DRY_ARCH,
                        shape: str = DRY_SHAPE, config=None) -> dict:
    """(d): one full-width cell at 256 fake ranks on fake tensors of the
    card's type, beside the advisor's estimate of the same layout.  Nothing
    is launched."""
    def counts():
        return (launch_counts(), lm_counts(), train_counts())
    before = counts()
    t0 = time.perf_counter()
    art = lower_cell(arch, shape, False, device=device, config=config)
    wall = time.perf_counter() - t0
    if counts() != before:
        fail("phase 19 (d): the dry run launched a kernel")
    pc, cfg_over = default_parallel(arch, shape)
    cfg = dataclasses.replace(config or get_config(arch), **cfg_over)
    sc = SHAPES[shape]
    kv = pc.decode_kv
    if kv == "auto":
        kv = "heads" if cfg.n_kv_heads and cfg.n_kv_heads % 16 == 0 \
            else "sequence"
    plan = ShardPlan(data=16, model=16, microbatch=pc.microbatch,
                     remat=pc.remat, fsdp=True, decode_kv=kv,
                     seq_shard=pc.seq_shard)
    est = predict(cfg, sc, plan).to_dict()
    rl = art["roofline"]
    print(f"phase 19 (d) dry run {arch} {shape} on 256 fake ranks ({device}"
          f" fake tensors): traced in {art['lower_s']} s ({wall:.1f} s with "
          f"the layout), {art['operators']} operators; per device "
          f"{art['flops_per_device']:.6e} FLOPs, {art['bytes_per_device']:.6e}"
          f" bytes (every operator's: {art['bytes_all_per_device']:.6e}), "
          f"wire {json.dumps(art['collectives']['wire_bytes'])} "
          f"({art['collectives']['inter_node_wire_bytes']:.6e} of it across "
          f"nodes), collectives {json.dumps(art['collectives']['counts'])}, "
          f"traced peak {art['memory']['peak_bytes'] / 2**30:.3f} GiB; "
          f"roofline compute {rl['compute_s']:.6e} s, memory "
          f"{rl['memory_s']:.6e} s, collective {rl['collective_s']:.6e} s, "
          f"{rl['bottleneck']}-bound, fraction {rl['roofline_frac']:.4f}; "
          f"the advisor's predict ({plan}): compute {est['compute_s']:.6e}"
          f" s, memory {est['memory_s']:.6e} s, collective "
          f"{est['collective_s']:.6e} s, step {est['step_s']:.6e} s",
          flush=True)
    return dict(artifact=art, wall_s=wall, advisor=est,
                plan=dataclasses.asdict(plan))


def multirank_phase(problem, cold, cold_s: float, cold_launches: int,
                    served: dict) -> dict:
    t0 = time.perf_counter()
    out = dict(islands=islands_on_card(problem, cold, cold_s,
                                       cold_launches))
    out["sharded"] = sharded_serve_and_restore(served)
    free_card()
    out["dryrun"] = dryrun_cell_on_card()
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 19: {out['wall_s']:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    t_run = time.perf_counter()

    def stamp(phases: str):
        """The run's clock at the end of ``phases``, flushed, so that a run
        stopped at its time limit still shows how far it got."""
        print(f"phases {phases} ended {time.perf_counter() - t_run:.1f} s "
              f"into the run", flush=True)
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
    stamp("1-2")

    # ---- 3. kernels against their plain versions ---------------------------
    pareto_rows = check_pareto_rank(sm_clock_hz)
    gp_rows = check_gp_cov(sm_clock_hz)
    fa_probe = tf32_probe_report()
    fa_rows = check_flash_attention()
    ms_rows = check_mamba_scan(sm_clock_hz)
    stamp("3")

    # ---- 4. evaluator golden vectors --------------------------------------
    check_golden()

    # ---- 5. the main path, cold --------------------------------------------
    problem = main_problem()
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
    stamp("4-6")

    # ---- 7. where the time goes --------------------------------------------
    split = breakdown(problem)
    stamp("7")

    # ---- 8. the quickstart query: BO x SA with gp_cov ----------------------
    quick = quickstart()
    stamp("8")

    # ---- 9. two_stage with an archive --------------------------------------
    staged = two_stage()
    stamp("9")

    # ---- 10. the LM serving slice: card against CPU -----------------------
    lm_parity = hymba_card_vs_cpu()
    stamp("10")

    # ---- 11. the LM serving slice at full size -----------------------------
    served = hymba_serve()
    stamp("11")

    # ---- 12. transfer, fleet cache and resume on the card -----------------
    transfer = transfer_phase(problem, cold)
    stamp("12")

    # ---- 13. megabatched and surrogate-gated search on the card -----------
    fused = megabatch_phase()
    stamp("13")

    # ---- 14. calibration and the flight recorder on the card --------------
    calib_obs = calib_obs_phase(problem)
    stamp("14")

    # ---- 15. the async serving shell on the card ---------------------------
    serving = serve_phase(problem)
    stamp("15")

    # ---- 16. every LM family on the card -----------------------------------
    families = families_phase()
    stamp("16")

    # ---- 17. training on the card -------------------------------------------
    trained = train_phase(sm_clock_hz)
    stamp("17")

    # ---- 18. the front door's tail and the planning layer --------------------
    planned = planning_phase(served, trained["train"])
    stamp("18")

    # ---- 19. the multi-rank half on one card -------------------------------
    multi = multirank_phase(problem, cold, cold_s, launches, served)
    stamp("19")

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
                       breakdown=split, transfer=transfer,
                       calib_obs=calib_obs, serve=serving,
                       islands=multi["islands"]))
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
        main_path=dict(quickstart=quick, two_stage=staged, transfer=dict(
            readings="pareto_rank's main_path.transfer",
            seeded_bo_sa_launches=transfer["seeded_bo_sa"]["launches"])))
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
        build=fa_build, shapes=bf16_rows,
        main_path=dict(serve=served, families=families["serve"],
                       sharded=multi["sharded"]),
        launches_families={r["arch"]: r["launches"]["flash_attention_tc"]
                           for r in families["serve"]})
    f32_main = next(r for r in f32_rows if r["tag"] == "hymba prefill")
    fa_f32_record = dict(
        name="flash_attention_f32", route="cuda",
        source=FA_SOURCES + "flash_attention_tf32.cu", replaces=FA_REPLACES,
        dtype="float32", launches=lm_parity["launches"]["flash_attention"],
        launches_tc=lm_parity["launches"]["tensor_core"],
        tf32_probe=fa_probe,
        max_abs_err=max(r["max_abs_err"] for r in f32_rows),
        ms=f32_main["ms"], plain_ms=f32_main["plain_ms"],
        bound_ms=f32_main["bound_ms"], bound_by=f32_main["bound_by"],
        library_ms=f32_main["library_ms"], tolerance=FA_TOL[torch.float32],
        shapes=f32_rows, main_path=dict(
            card_vs_cpu=lm_parity,
            families_card_vs_cpu=families["card_vs_cpu"]))
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
        launches_families={r["arch"]: r["launches"]["mamba_scan"]
                           for r in families["serve"]},
        build=ms_build["forward"], shapes=ms_rows)
    lane_rows = fused["lane_shapes"]
    lane_main = next(r for r in lane_rows if r["tag"] == "fused selection")
    lanes_record = dict(
        name="pareto_rank_lanes", route="cuda", source=record["source"],
        replaces=record["replaces"],
        launches=fused["submit"]["fused"]["launches_lanes"],
        max_abs_err=max(r["max_abs_err"] for r in lane_rows),
        ms=lane_main["ms"], plain_ms=lane_main["plain_ms"],
        bound_ms=lane_main["bound_ms"], bound_by=lane_main["bound_by"],
        library_ms=None, exact=True,
        device_ms_per_launch=lane_main["device_ms"],
        singles_ms=lane_main["singles_ms"],
        singles_device_ms=lane_main["singles_device_ms"], shapes=lane_rows,
        main_path=fused)
    fa_bwd = next(r for r in trained["fa_bwd"] if r["tag"] == "hymba train"
                  and r["dtype"] == str(torch.bfloat16))
    fa_bwd_record = dict(
        name="flash_attention_bwd", route="cuda", source=FA_BWD_SOURCE,
        replaces="src/repro/kernels/flash_attention/ops.py:166 (_fa_diff_bwd,"
                 " the custom VJP of " + FA_REPLACES + ")",
        launches=trained["train"]["launches"]["flash_attention_bwd"],
        launches_per_call=fa_ops.BWD_LAUNCHES,
        max_abs_err=max(r["max_abs_err"] for r in trained["fa_bwd"]),
        ms=fa_bwd["ms"], plain_ms=fa_bwd["plain_ms"],
        bound_ms=fa_bwd["bound_ms"], bound_by=fa_bwd["bound_by"],
        library_ms=fa_bwd["library_ms"], dtype="bfloat16",
        float32_source=FA_SOURCES + "flash_attention_bwd_tf32.cu",
        occupancy=fa_bwd["occupancy"], vs_float32=fa_bwd["vs_float32"],
        build=fa_build["backward"],
        tolerance={"torch.float32": [FA_BWD_F32_TOL, FA_BWD_F32_TOL],
                   "torch.bfloat16": dict(
                       atol_of_max=TC_BWD_ATOL_OF_MAX, rtol=TC_BWD_RTOL,
                       max_past=TC_BWD_MAX_PAST,
                       past_of_max=TC_BWD_PAST_OF_MAX)},
        sdpa_factor=FA_BWD_SDPA_FACTOR,
        shapes=trained["fa_bwd"],
        main_path=dict(train=trained["train"],
                       card_vs_cpu=trained["card_vs_cpu"],
                       fault_tolerant=trained["fault_tolerant"]))
    ms_bwd = next(r for r in trained["ms_bwd"] if r["tag"] == "hymba train")
    ms_bwd_record = dict(
        name="mamba_scan_bwd", route="cuda", source=MS_BWD_SOURCE,
        replaces="src/repro/kernels/mamba_scan/ops.py:26 (autodiff of "
                 "selective_scan_assoc; the forward is "
                 "src/repro/kernels/mamba_scan/mamba_scan.py:63)",
        launches=trained["train"]["launches"]["mamba_scan_bwd"],
        launches_per_call=ms_ops.BWD_LAUNCHES,
        max_abs_err=max(r["max_abs_err"] for r in trained["ms_bwd"]),
        ms=ms_bwd["ms"], plain_ms=ms_bwd["plain_ms"],
        bound_ms=ms_bwd["bound_ms"], bound_by=ms_bwd["bound_by"],
        byte_bound_ms=ms_bwd["byte_bound_ms"],
        sfu_floor_ms=ms_bwd["sfu_floor_ms"], split=ms_bwd["split"],
        states_bytes=ms_bwd["states_bytes"],
        forward_with_states_ms=ms_bwd["fwd_states_ms"],
        forward_ms=ms_bwd["fwd_ms"],
        library_ms=None, tolerance=MS_BWD_TOL, build=ms_build["backward"],
        shapes=trained["ms_bwd"])
    print(json.dumps({"kernels": [record, gp_record, fa_record,
                                  fa_f32_record, ms_record, lanes_record,
                                  fa_bwd_record, ms_bwd_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# --loss-drift: the attention backwards each arm trains with
DRIFT_ARMS = ("kernel", "kernel again", "sdpa", "float32")


def sdpa_bwd(q, k, v, out, lse, dout, mask_kind="causal", window=0,
             kv_valid_len=None):
    """``flash_attention_bwd``'s contract through the backward of one
    ``scaled_dot_product_attention`` call."""
    with torch.enable_grad():       # autograd's backward runs without it
        return tuple(g.contiguous() for g in sdpa_grads(
            q, k, v, dout, mask_kind, window, kv_valid_len))


def float32_bwd(kernel):
    """``flash_attention_bwd``'s contract through the float32 kernels
    (3xTF32 on the tensor cores) on float32 copies of the inputs, each
    gradient rounded once to its input's dtype."""
    def bwd(q, k, v, out, lse, dout, mask_kind="causal", window=0,
            kv_valid_len=None):
        grads = kernel(q.float(), k.float(), v.float(), out.float(), lse,
                       dout.float(), mask_kind, window, kv_valid_len)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
    return bwd


def loss_drift():
    """Phase 17 (c)'s 6 steps from seed 0 under each arm of DRIFT_ARMS."""
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    kernel = fa_ops.flash_attention_bwd
    swap = {"sdpa": sdpa_bwd, "float32": float32_bwd(kernel)}
    cfg = get_config(HYMBA)
    losses = {}
    for arm in DRIFT_ARMS:
        t0 = time.perf_counter()
        model = build_model(cfg, "cuda")
        state = make_train_state(model, 0, TRAIN_OPT)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
        fa_ops.flash_attention_bwd = swap.get(arm, kernel)
        try:
            res, state = train_loop(model, state,
                                    data.stream(0, TRAIN_STEPS),
                                    make_train_step(model, TRAIN_OPT),
                                    log_every=0)
        finally:
            fa_ops.flash_attention_bwd = kernel
        losses[arm] = res.losses
        del model, state
        free_card()
        print(f"loss drift, {arm}: losses {json.dumps(res.losses)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not all(np.isfinite(res.losses)):
            fail(f"loss drift, {arm}: non-finite loss {res.losses}")
    spread = {f"{a} - {b}": max(abs(x - y) for x, y in zip(losses[a],
                                                             losses[b]))
              for a, b in (("kernel", "kernel again"), ("kernel", "float32"),
                           ("sdpa", "float32"), ("kernel", "sdpa"))}
    print(json.dumps({"loss_drift": dict(steps=TRAIN_STEPS, losses=losses,
                                         largest_difference=spread)}))
    print(smi)


if __name__ == "__main__":
    if sys.argv[1:] == ["--loss-drift"]:
        loss_drift()
    else:
        main()
