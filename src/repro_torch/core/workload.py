"""Tensor-workload IR (paper Sec. II-A / III-A).

The PyTorch port's copy of ``repro.core.workload`` (numpy only).  The padded
arrays keep the reference's dtypes (``bounds`` int32, ``A`` int8, masks
bool), so content hashes of a spec agree between the two packages.

A *workload* is a perfectly-nested loop program over tensors — an operation
expressible as  ``Out[f(idx)] (+)= Π_i In_i[g_i(idx)]``  (matmul, convolution,
MTTKRP, tensor-train contractions, ...).  Each tensor dimension indexes either
a single loop (``("k",)``) or a sliding-window sum of loops (``("p","r")`` for
``p+r`` in a convolution), which is all the reuse analysis needs:

* footprint of a dim-group under tile sizes t:  sum(t_l) - (len-1)
* a loop is *relevant* to a tensor iff it appears in any dim-group.

A ``WorkloadGraph`` is the paper's dependency graph G=(V,E): vertices are
workloads, edges carry the tensor that flows producer -> consumer (used for
the data-dependency set Omega and the communication graph).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_LOOPS = 8          # padded loop-nest width for the vectorized evaluator
MAX_TENSORS = 4        # operands + output per workload
MAX_DIMS = 4           # dims per tensor


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """One tensor access inside a workload."""
    name: str
    dims: Tuple[Tuple[str, ...], ...]     # dim-groups, e.g. (("i",), ("k",))
    is_output: bool = False

    def loops(self) -> Tuple[str, ...]:
        out: List[str] = []
        for grp in self.dims:
            for l in grp:
                if l not in out:
                    out.append(l)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A single tensor workload: loop bounds + tensor accesses."""
    name: str
    loops: Tuple[Tuple[str, int], ...]    # ordered (loop name, bound)
    tensors: Tuple[TensorRef, ...]
    flops_per_instance: int = 2           # one MAC

    # ------------------------------------------------------------------ api
    @property
    def loop_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.loops)

    @property
    def bounds(self) -> Dict[str, int]:
        return dict(self.loops)

    @property
    def macs(self) -> int:
        return int(np.prod([b for _, b in self.loops], dtype=np.int64))

    @property
    def flops(self) -> int:
        return self.macs * self.flops_per_instance

    def output(self) -> TensorRef:
        for t in self.tensors:
            if t.is_output:
                return t
        raise ValueError(f"workload {self.name} has no output tensor")

    def tensor(self, name: str) -> TensorRef:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)

    def tensor_size(self, name: str) -> int:
        """Number of elements of a tensor under the full loop bounds."""
        t = self.tensor(name)
        b = self.bounds
        size = 1
        for grp in t.dims:
            size *= sum(b[l] for l in grp) - (len(grp) - 1)
        return int(size)

    # ------------------------------------------------------- array encoding
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Pad to fixed shapes for the vmappable evaluator.

        Returns
        -------
        bounds:  (MAX_LOOPS,) int32, padded with 1
        loopmask:(MAX_LOOPS,) bool
        A:       (MAX_TENSORS, MAX_DIMS, MAX_LOOPS) int8 dim-group incidence
        tmask:   (MAX_TENSORS,) bool
        dmask:   (MAX_TENSORS, MAX_DIMS) bool
        is_out:  (MAX_TENSORS,) bool
        """
        ln = self.loop_names
        if len(ln) > MAX_LOOPS:
            raise ValueError(f"{self.name}: too many loops ({len(ln)})")
        if len(self.tensors) > MAX_TENSORS:
            raise ValueError(f"{self.name}: too many tensors")
        idx = {n: i for i, n in enumerate(ln)}
        bounds = np.ones(MAX_LOOPS, np.int32)
        for i, (_, b) in enumerate(self.loops):
            bounds[i] = b
        loopmask = np.zeros(MAX_LOOPS, bool)
        loopmask[: len(ln)] = True
        A = np.zeros((MAX_TENSORS, MAX_DIMS, MAX_LOOPS), np.int8)
        tmask = np.zeros(MAX_TENSORS, bool)
        dmask = np.zeros((MAX_TENSORS, MAX_DIMS), bool)
        is_out = np.zeros(MAX_TENSORS, bool)
        for ti, t in enumerate(self.tensors):
            tmask[ti] = True
            is_out[ti] = t.is_output
            if len(t.dims) > MAX_DIMS:
                raise ValueError(f"{self.name}.{t.name}: too many dims")
            for di, grp in enumerate(t.dims):
                dmask[ti, di] = True
                for l in grp:
                    A[ti, di, idx[l]] = 1
        return dict(bounds=bounds, loopmask=loopmask, A=A, tmask=tmask,
                    dmask=dmask, is_out=is_out)


# ---------------------------------------------------------------------------
# constructors for the workload kinds used in the paper
# ---------------------------------------------------------------------------
def matmul(name: str, M: int, N: int, K: int) -> Workload:
    """C[i,j] += A[i,k] * B[k,j]"""
    return Workload(
        name=name,
        loops=(("i", M), ("j", N), ("k", K)),
        tensors=(
            TensorRef("A", (("i",), ("k",))),
            TensorRef("B", (("k",), ("j",))),
            TensorRef("C", (("i",), ("j",)), is_output=True),
        ),
    )


def conv2d(name: str, N: int, K: int, C: int, P: int, Q: int,
           R: int, S: int) -> Workload:
    """O[n,k,p,q] += W[k,c,r,s] * I[n,c,p+r,q+s]   (stride 1, 7 loops)."""
    return Workload(
        name=name,
        loops=(("n", N), ("k", K), ("p", P), ("q", Q),
               ("c", C), ("r", R), ("s", S)),
        tensors=(
            TensorRef("I", (("n",), ("c",), ("p", "r"), ("q", "s"))),
            TensorRef("W", (("k",), ("c",), ("r",), ("s",))),
            TensorRef("O", (("n",), ("k",), ("p",), ("q",)), is_output=True),
        ),
    )


def mttkrp(name: str, I: int, J: int, K: int, L: int) -> Workload:
    """O[i,j] += T[i,k,l] * B[k,j] * C[l,j]"""
    return Workload(
        name=name,
        loops=(("i", I), ("j", J), ("k", K), ("l", L)),
        tensors=(
            TensorRef("T", (("i",), ("k",), ("l",))),
            TensorRef("B", (("k",), ("j",))),
            TensorRef("C", (("l",), ("j",))),
            TensorRef("O", (("i",), ("j",)), is_output=True),
        ),
        flops_per_instance=3,
    )


def contraction(name: str, free_a: Dict[str, int], free_b: Dict[str, int],
                contracted: Dict[str, int],
                a_name: str = "A", b_name: str = "B",
                out_name: str = "O") -> Workload:
    """Generalized tensor contraction  O[fa, fb] += A[fa, c] * B[c, fb]
    (the tensor-train building block, paper Fig. 10)."""
    loops = tuple(free_a.items()) + tuple(free_b.items()) \
        + tuple(contracted.items())
    return Workload(
        name=name,
        loops=loops,
        tensors=(
            TensorRef(a_name, tuple((l,) for l in list(free_a) + list(contracted))),
            TensorRef(b_name, tuple((l,) for l in list(contracted) + list(free_b))),
            TensorRef(out_name, tuple((l,) for l in list(free_a) + list(free_b)),
                      is_output=True),
        ),
    )


# ---------------------------------------------------------------------------
# workload graphs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Edge:
    src: int                      # producer workload index
    dst: int                      # consumer workload index
    tensor_src: str               # tensor name in producer (its output)
    tensor_dst: str               # tensor name in consumer (an input)


@dataclasses.dataclass
class WorkloadGraph:
    """Dependency graph of tensor workloads (paper Def. 1)."""
    workloads: List[Workload]
    edges: List[Edge]

    def __post_init__(self):
        n = len(self.workloads)
        for e in self.edges:
            assert 0 <= e.src < n and 0 <= e.dst < n and e.src != e.dst
            self.workloads[e.src].tensor(e.tensor_src)
            self.workloads[e.dst].tensor(e.tensor_dst)

    @property
    def n(self) -> int:
        return len(self.workloads)

    def transfer_elems(self, e: Edge) -> int:
        """|Omega_{G1,G2}|: elements flowing producer->consumer = size of the
        produced tensor restricted to what the consumer reads (here: the full
        produced tensor; validated element-wise in mapping.py / tests)."""
        return self.workloads[e.src].tensor_size(e.tensor_src)

    def external_inputs(self) -> List[Tuple[int, str]]:
        """(workload, tensor) pairs that must be streamed from DRAM."""
        produced = {(e.dst, e.tensor_dst) for e in self.edges}
        out = []
        for wi, w in enumerate(self.workloads):
            for t in w.tensors:
                if not t.is_output and (wi, t.name) not in produced:
                    out.append((wi, t.name))
        return out

    def final_outputs(self) -> List[Tuple[int, str]]:
        """(workload, tensor) outputs that nobody consumes -> written to DRAM."""
        consumed = {(e.src, e.tensor_src) for e in self.edges}
        out = []
        for wi, w in enumerate(self.workloads):
            t = w.output()
            if (wi, t.name) not in consumed:
                out.append((wi, t.name))
        return out

    def topo_order(self) -> List[int]:
        indeg = [0] * self.n
        adj: List[List[int]] = [[] for _ in range(self.n)]
        for e in self.edges:
            adj[e.src].append(e.dst)
            indeg[e.dst] += 1
        stack = [i for i in range(self.n) if indeg[i] == 0]
        order: List[int] = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if len(order) != self.n:
            raise ValueError("workload graph has a cycle")
        return order

    def depth(self) -> int:
        """Longest producer->consumer chain length (nodes on the critical
        dependency path; 1 for an edgeless graph)."""
        dist = [1] * self.n
        for u in self.topo_order():
            for e in self.edges:
                if e.src == u:
                    dist[e.dst] = max(dist[e.dst], dist[u] + 1)
        return max(dist) if dist else 0


# ---------------------------------------------------------------------------
# workload identity + feature embeddings (the cross-spec transfer substrate)
# ---------------------------------------------------------------------------
# Per-workload feature row layout (all sizes log2-scaled so magnitudes are
# comparable across wildly different problem sizes):
#   [0:L)       loop bounds in declared order, padded with 1
#   [L:2L)      loop bounds sorted descending (permutation-invariant view)
#   [2L:2L+T)   tensor sizes sorted descending, padded with 1
#   then: n_loops, n_tensors, macs, output size, total footprint,
#         in-degree, out-degree
WL_FEATURE_DIM = 2 * MAX_LOOPS + MAX_TENSORS + 7
# graph summary: n workloads, n edges, DAG depth, external inputs, final
# outputs, total macs (log2), total producer->consumer elements (log2)
GRAPH_SUMMARY_DIM = 7
# workload_features(graph) = [mean rows | max rows | graph summary]
WL_EMBED_DIM = 2 * WL_FEATURE_DIM + GRAPH_SUMMARY_DIM


def workload_signature(w: Workload) -> str:
    """Content hash of one workload's *structure*: padded loop bounds and
    dim-group incidence, NOT its name.  Two workloads with equal signatures
    are the same tensor program, so per-workload design records transfer
    between them verbatim (``encoding.PortableDesign``)."""
    arr = w.to_arrays()
    h = hashlib.sha256()
    h.update(repr(int(w.flops_per_instance)).encode())
    for k in sorted(arr):
        a = np.asarray(arr[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _log2(x) -> np.ndarray:
    return np.log2(np.maximum(np.asarray(x, np.float64), 1.0))


def workload_feature_row(w: Workload, in_deg: int = 0,
                         out_deg: int = 0) -> np.ndarray:
    """(WL_FEATURE_DIM,) numeric fingerprint of one workload — what
    nearest-record matching ranks on when no exact signature match exists."""
    bounds = np.ones(MAX_LOOPS, np.float64)
    for i, (_, b) in enumerate(w.loops):
        bounds[i] = b
    tsizes = np.ones(MAX_TENSORS, np.float64)
    for i, t in enumerate(w.tensors):
        tsizes[i] = w.tensor_size(t.name)
    return np.concatenate([
        _log2(bounds),
        np.sort(_log2(bounds))[::-1],
        np.sort(_log2(tsizes))[::-1],
        [float(len(w.loops)), float(len(w.tensors)),
         float(_log2(w.macs)), float(_log2(w.tensor_size(w.output().name))),
         float(_log2(tsizes.sum())), float(in_deg), float(out_deg)],
    ])


def graph_feature_rows(graph: WorkloadGraph) -> np.ndarray:
    """(n, WL_FEATURE_DIM) per-workload feature matrix with edge degrees."""
    indeg = np.zeros(graph.n, np.int64)
    outdeg = np.zeros(graph.n, np.int64)
    for e in graph.edges:
        outdeg[e.src] += 1
        indeg[e.dst] += 1
    return np.stack([workload_feature_row(w, int(indeg[i]), int(outdeg[i]))
                     for i, w in enumerate(graph.workloads)])


def workload_features(graph: WorkloadGraph) -> np.ndarray:
    """Fixed-dimension (WL_EMBED_DIM,) embedding of a whole workload graph:
    mean- and max-pooled per-workload rows plus a graph-structure summary.
    Graphs of any size land in ONE vector space, so the explore cache can
    rank cached problems by similarity (``ArchiveManifest.nearest``) and
    warm-start new graphs from their neighbors' fronts."""
    rows = graph_feature_rows(graph)
    transfer = sum(graph.transfer_elems(e) for e in graph.edges)
    summary = np.asarray([
        float(graph.n), float(len(graph.edges)), float(graph.depth()),
        float(len(graph.external_inputs())), float(len(graph.final_outputs())),
        float(_log2(sum(w.macs for w in graph.workloads))),
        float(_log2(transfer)),
    ])
    return np.concatenate([rows.mean(axis=0), rows.max(axis=0), summary])


def embedding_delta(a, b) -> np.ndarray:
    """Per-dimension absolute difference of two ``workload_features``
    embeddings — the feature vector the transfer trust calibration
    (``repro.explore.archive.fit_trust_model``) regresses observed
    hypervolume lift on.  Symmetric in (a, b) and all-zero iff the
    embeddings coincide."""
    return np.abs(np.asarray(a, np.float64).ravel()
                  - np.asarray(b, np.float64).ravel())
