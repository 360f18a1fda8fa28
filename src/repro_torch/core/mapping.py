"""The paper's mapping formalism (Sec. III-B): Map / Bind / Reduce.

This module is the *semantic reference* for the fast closed-form evaluator:
it enumerates loop instances explicitly (small bounds only), so tests can
check the closed-form transfer volumes / reuse counts used by
``dataflow.py`` and ``evaluate.py`` against element-level ground truth.

    Map(G, chi)     : loop instance -> cluster coordinate [p0, p1, p2]
    Bind(chi, C)    : cluster chiplet -> system chiplet (execution sequence)
    Reduce_r(G, G') : gather vertices under rule r (hierarchical graphs)
    Omega(G1, G2, F): {(max P_{G1,F[f]}, min P_{G2,F[f]}) for all f}

The port's own copy of ``repro.core.mapping`` (numpy), over the port's
``core.workload`` classes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .workload import TensorRef, Workload


Coord = Tuple[int, ...]


@dataclasses.dataclass
class Cluster:
    """A domain of computing engines (paper Def. 3), one entry per level:
    e.g. dims = {"chiplet": (2, 2), "core": (2, 2), "pe": (4, 4)}."""
    dims: Dict[str, Tuple[int, int]]

    def size(self, level: str) -> int:
        x, y = self.dims[level]
        return x * y


def enumerate_instances(w: Workload) -> np.ndarray:
    """All loop instances of a workload as an (N, n_loops) int array, in
    lexicographic (declared-order) execution sequence."""
    bounds = [b for _, b in w.loops]
    grids = np.indices(bounds).reshape(len(bounds), -1).T
    return grids


def map_instances(w: Workload, cluster: Cluster,
                  spatial: Dict[str, Tuple[str, str]]) -> np.ndarray:
    """Map(G, chi): assign every loop instance a coordinate per level via
    modulo parallelization of the chosen spatial loops, e.g.
    ``S[i,j,k] -> PE[i % X, j % Y]`` (paper Sec. III-B example).

    Returns (N, n_levels * 2) coordinates, level order = cluster.dims order.
    """
    inst = enumerate_instances(w)
    names = list(w.loop_names)
    cols = []
    for level, (X, Y) in cluster.dims.items():
        lx, ly = spatial[level]
        cols.append(inst[:, names.index(lx)] % X)
        cols.append(inst[:, names.index(ly)] % Y)
    return np.stack(cols, axis=1)


def bind(cluster_chiplets: Sequence[Coord],
         system_chiplets: Sequence[int]) -> Dict[Coord, int]:
    """Bind(chi, C): cluster coordinate -> system chiplet id; binding order
    encodes the execution sequence on shared chiplets (paper Fig. 4d)."""
    assert len(cluster_chiplets) == len(system_chiplets)
    return dict(zip(cluster_chiplets, system_chiplets))


def reduce_graph(assignment: np.ndarray) -> Dict[Tuple, np.ndarray]:
    """Reduce_r(G, G'): gather instances by an assignment key (e.g. their
    core coordinate) into super-vertices.  Returns key -> instance indices."""
    out: Dict[Tuple, List[int]] = {}
    for i, key in enumerate(map(tuple, assignment)):
        out.setdefault(key, []).append(i)
    return {k: np.asarray(v) for k, v in out.items()}


def _element_of(t: TensorRef, names: List[str], inst: np.ndarray) -> Tuple:
    idx = []
    for grp in t.dims:
        idx.append(sum(int(inst[names.index(l)]) for l in grp))
    return tuple(idx)


def omega(producer: Workload, consumer: Workload,
          t_prod: str, t_cons: str) -> List[Tuple[int, int]]:
    """Data-dependence set Omega_{G1,G2} (paper Sec. III-B): for every element
    f of the shared tensor, connect the LAST producer instance writing f with
    the FIRST consumer instance reading f.  Returns instance-index pairs.

    Element-count |Omega| is what the fast evaluator uses as transfer volume.
    """
    tp = producer.tensor(t_prod)
    tc = consumer.tensor(t_cons)
    pn, cn = list(producer.loop_names), list(consumer.loop_names)

    last_write: Dict[Tuple, int] = {}
    for i, inst in enumerate(enumerate_instances(producer)):
        last_write[_element_of(tp, pn, inst)] = i

    first_read: Dict[Tuple, int] = {}
    for i, inst in enumerate(enumerate_instances(consumer)):
        f = _element_of(tc, cn, inst)
        if f not in first_read:
            first_read[f] = i

    pairs = []
    for f, wi in last_write.items():
        if f in first_read:
            pairs.append((wi, first_read[f]))
    return pairs
