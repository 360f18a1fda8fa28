"""Readable reference implementation of the pipeline performance model
(paper Sec. III-C, Fig. 5).  The fast path lives in ``evaluate.py``; this
module exists so tests and the validation benchmark can express the paper's
examples directly:

    Lat = max_{p in P} sum_{v in p} D(v),   Thr = 1 / max_v D(v)

Stages are compute stages (workloads bound to chiplets; workloads sharing a
chiplet become one long sequential stage — paper Fig. 4d) and data-transfer
stages between them.

The port's own copy of ``repro.core.perf_model`` (plain Python, no tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class Stage:
    name: str
    delay: float                       # ns
    kind: str = "compute"              # or "transfer"


@dataclasses.dataclass
class StageGraph:
    stages: List[Stage]
    edges: List[Tuple[int, int]]       # stage index -> stage index

    def latency(self) -> float:
        """Longest path over the stage DAG."""
        n = len(self.stages)
        indeg = [0] * n
        adj: List[List[int]] = [[] for _ in range(n)]
        for u, v in self.edges:
            adj[u].append(v)
            indeg[v] += 1
        dist = [s.delay for s in self.stages]
        order = [i for i in range(n) if indeg[i] == 0]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for v in adj[u]:
                dist[v] = max(dist[v], dist[u] + self.stages[v].delay)
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        if len(order) != n:
            raise ValueError("stage graph has a cycle")
        return max(dist) if dist else 0.0

    def throughput(self) -> float:
        mx = max((s.delay for s in self.stages), default=0.0)
        return 1.0 / mx if mx > 0 else float("inf")

    def total_time(self, ticks: int = 1) -> float:
        """Latency of the first tick + (ticks-1) pipeline intervals."""
        return self.latency() + (ticks - 1) / self.throughput()


def build_stage_graph(compute_delays: Dict[int, float],
                      binding: Dict[int, int],
                      deps: Sequence[Tuple[int, int, float]]) -> StageGraph:
    """Compose stages from workload delays + chiplet binding + transfers.

    compute_delays: workload -> D(v);  binding: workload -> chiplet id
    (workloads bound to the same chiplet are concatenated, in key order,
    into one long stage);  deps: (producer wl, consumer wl, transfer delay).
    """
    by_chip: Dict[int, List[int]] = {}
    for wl in sorted(compute_delays):
        by_chip.setdefault(binding[wl], []).append(wl)

    stages: List[Stage] = []
    stage_of: Dict[int, int] = {}
    for chip, wls in sorted(by_chip.items()):
        idx = len(stages)
        stages.append(Stage(
            name=f"chip{chip}:" + "+".join(f"w{w}" for w in wls),
            delay=sum(compute_delays[w] for w in wls)))
        for w in wls:
            stage_of[w] = idx

    edges: List[Tuple[int, int]] = []
    for src, dst, tdelay in deps:
        su, sv = stage_of[src], stage_of[dst]
        if su == sv:
            continue                   # same chiplet: already serialized
        t = len(stages)
        stages.append(Stage(name=f"xfer w{src}->w{dst}", delay=tdelay,
                            kind="transfer"))
        edges.append((su, t))
        edges.append((t, sv))
    return StageGraph(stages, edges)
