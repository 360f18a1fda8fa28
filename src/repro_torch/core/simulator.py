"""Cycle-approximate systolic-array simulator (ScaleSim [23] stand-in).

The paper validates its analytical model against ScaleSim on a four-chip
transformer (8x8 PE arrays) and reports <= 9.8% latency error (Sec. V-A).
ScaleSim is not available offline, so we implement the same class of
simulator: an output-stationary systolic array executed fold-by-fold with
explicit pipeline fill/drain skew and double-buffered operand streaming —
the standard ScaleSim timing equations — and validate our analytical model
against it in ``benchmarks/bench_validation.py``.

The port's own copy of ``repro.core.simulator`` (plain Python): the
calibration fit (``repro_torch.calib``) takes its measurements from it.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SystolicConfig:
    array_x: int = 8            # PE rows
    array_y: int = 8            # PE cols
    dram_bw_gbps: float = 128.0
    clock_ghz: float = 1.0
    bytes_per_elem: int = 2
    dma_setup_cycles: int = 16  # per-fold DMA/descriptor overhead


def simulate_matmul(M: int, N: int, K: int, cfg: SystolicConfig) -> dict:
    """Output-stationary systolic execution of C[M,N] = A[M,K] @ B[K,N].

    The array computes an (array_x x array_y) output tile per fold; a fold
    streams K partial sums through the array with (array_x + array_y - 2)
    fill/drain skew (ScaleSim OS timing: 2*rows + cols + K - 2 per fold).
    Cycle-level effects the analytical model deliberately abstracts — and
    which the Sec.-V-A validation therefore measures:
      * the FIRST fold's operand load is not overlapped (cold start),
      * each fold pays a DMA setup overhead,
      * edge folds run at their true (rows, cols), not the padded tile.
    """
    X, Y = cfg.array_x, cfg.array_y
    folds_m = math.ceil(M / X)
    folds_n = math.ceil(N / Y)
    bytes_per_cycle = cfg.dram_bw_gbps / cfg.clock_ghz     # bytes / cycle

    def stream_cycles(rows, cols):
        a = rows * K * cfg.bytes_per_elem
        b = K * cols * cfg.bytes_per_elem
        c = rows * cols * cfg.bytes_per_elem
        return (a + b + c) / bytes_per_cycle

    cycles = stream_cycles(min(X, M), min(Y, N))           # cold start
    for fm in range(folds_m):
        rows = min(X, M - fm * X)
        for fn in range(folds_n):
            cols = min(Y, N - fn * Y)
            compute = 2 * rows + cols + K - 2
            cycles += max(compute, stream_cycles(rows, cols)) \
                + cfg.dma_setup_cycles
    total_macs = M * N * K
    return dict(
        cycles=cycles,
        latency_ns=cycles / cfg.clock_ghz,
        utilization=total_macs / (cycles * X * Y),
        macs=total_macs,
    )


def simulate_pipeline(stages, transfers) -> float:
    """Reference pipelined execution of dependent matmul stages on distinct
    chips (paper Fig. 5a): event-driven longest-path over (stage delays,
    transfer delays) — used to validate the StageGraph model."""
    from .perf_model import StageGraph, Stage
    stage_objs = [Stage(f"v{i}", d) for i, d in enumerate(stages)]
    edges = []
    for (u, v, d) in transfers:
        stage_objs.append(Stage(f"e{u},{v}", d, kind="transfer"))
        t = len(stage_objs) - 1
        edges.append((u, t))
        edges.append((t, v))
    return StageGraph(stage_objs, edges).latency()
