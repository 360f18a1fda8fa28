"""Measurement records + loaders for the three ground-truth sources.

A :class:`Measurement` is one externally measured (or published) PPA number
together with enough declarative metadata for the fit to rebuild the model's
prediction of the same quantity:

* ``kind="chiplet_matmul"`` — a single-chiplet matmul latency, predicted by
  ``analyze_chiplet`` under the ScaleSim-matched configuration that
  ``benchmarks/bench_validation.py`` uses (one 8x8 core, chiplet tile = one
  output fold).  Meta: ``M, N, K, bw`` (+ optional ``ax, ay`` array dims).
* ``kind="system"`` — a full-system metric of a *frozen baseline design*
  (Simba / NN-Baton / Monad class geometry from ``core.baselines``),
  predicted by ``evaluate_system``.  Meta: ``graph`` (a ``fig7_suite`` name),
  ``baseline``, ``pe_budget`` (+ optional ``ch_max, seed``).

Meta is stored as a sorted tuple of pairs so records stay hashable and
deterministic; ``measurements_digest`` gives the provenance digest carried
by :class:`~repro_torch.calib.preset.CalibratedTech` artifacts.

The port's own copy of ``repro.calib.measurements`` (plain Python): the
same records, loaders and digests, so both packages fit the same rows and
agree on a measurement set's identity.
"""

from __future__ import annotations

import csv
import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Sequence, Tuple

from ..core.simulator import SystolicConfig, simulate_matmul

KINDS = ("chiplet_matmul", "system")

#: default shape sweep — the reference's benchmarks/bench_validation.SHAPES
SWEEP_SHAPES = [(64, 64, 64), (128, 128, 128), (128, 512, 256),
                (256, 256, 256), (512, 512, 128), (512, 64, 512),
                (100, 100, 100), (72, 56, 40), (320, 192, 96)]
SWEEP_BWS = (128.0, 16.0)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One measured PPA number with declarative model-rebuild metadata."""
    kind: str                    # one of KINDS
    metric: str                  # latency_ns | energy_pj | area_mm2 | cost_usd
    value: float                 # measured ground truth (> 0)
    source: str = "external"     # provenance tag
    meta: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown measurement kind {self.kind!r}")
        if not (float(self.value) > 0):
            raise ValueError(f"measurement value must be > 0: {self.value}")

    @classmethod
    def make(cls, kind: str, metric: str, value: float,
             source: str = "external", **meta) -> "Measurement":
        return cls(kind, metric, float(value), source,
                   tuple(sorted(meta.items())))

    @property
    def info(self) -> Dict[str, object]:
        return dict(self.meta)

    def to_dict(self) -> Dict[str, object]:
        d = {"kind": self.kind, "metric": self.metric,
             "value": float(self.value), "source": self.source}
        d.update(self.info)
        return d


def measurements_digest(ms: Sequence[Measurement]) -> str:
    """Order-insensitive sha256 content digest of a measurement set."""
    rows = sorted(json.dumps(m.to_dict(), sort_keys=True, default=repr)
                  for m in ms)
    return hashlib.sha256("\n".join(rows).encode()).hexdigest()


# ---------------------------------------------------------------------------
# source 1: the cycle-approximate systolic simulator (ScaleSim stand-in)
# ---------------------------------------------------------------------------
def simulator_sweep(shapes: Iterable[Tuple[int, int, int]] = None,
                    bws: Iterable[float] = SWEEP_BWS,
                    array: Tuple[int, int] = (8, 8)) -> List[Measurement]:
    """Run ``simulate_matmul`` over a shape x bandwidth sweep and wrap each
    latency as a measurement (the Sec. V-A validation protocol)."""
    shapes = SWEEP_SHAPES if shapes is None else list(shapes)
    out = []
    for bw in bws:
        for (M, N, K) in shapes:
            cfg = SystolicConfig(array[0], array[1], dram_bw_gbps=float(bw))
            sim = simulate_matmul(M, N, K, cfg)
            out.append(Measurement.make(
                "chiplet_matmul", "latency_ns", sim["latency_ns"],
                source="simulator", M=M, N=N, K=K, bw=float(bw),
                ax=array[0], ay=array[1]))
    return out


# ---------------------------------------------------------------------------
# source 2: published Simba / NN-Baton baseline numbers
# ---------------------------------------------------------------------------
#: Published-literature system numbers for the two baseline architectures the
#: paper compares against (Sec. V-B), mapped onto the frozen baseline-class
#: designs that ``core.baselines.make_baseline`` realizes in this framework.
#: Simba (Shao et al., MICRO'19): 36-chiplet MCM, 6 mm^2 per chiplet in
#: 16 nm -> 216 mm^2 total silicon; package-level prototype cost class ~$100.
#: NN-Baton (Tan et al., ISCA'21): 4-chiplet-class organic package, ~20 mm^2
#: chiplets.  These are *class* numbers (the papers' nodes differ from the
#: 28 nm constants here) — exactly what the corr_area / corr_cost factors
#: absorb.
PUBLISHED_BASELINES = (
    dict(baseline="simba", graph="res4", pe_budget=1024,
         metric="area_mm2", value=216.0, source="published:simba-micro19"),
    dict(baseline="simba", graph="res4", pe_budget=1024,
         metric="cost_usd", value=110.0, source="published:simba-micro19"),
    dict(baseline="nn-baton", graph="res4", pe_budget=1024,
         metric="area_mm2", value=80.0, source="published:nnbaton-isca21"),
    dict(baseline="nn-baton", graph="res4", pe_budget=1024,
         metric="cost_usd", value=60.0, source="published:nnbaton-isca21"),
)


def baseline_measurements(rows: Iterable[dict] = PUBLISHED_BASELINES
                          ) -> List[Measurement]:
    """Wrap published baseline numbers as ``kind="system"`` measurements.

    Each row names a ``fig7_suite`` graph and a ``core.baselines`` baseline;
    the fit rebuilds the frozen baseline design deterministically (fixed
    PRNG seed) and compares ``evaluate_system`` output against the published
    value."""
    out = []
    for r in rows:
        r = dict(r)
        metric, value = r.pop("metric"), r.pop("value")
        source = r.pop("source", "published")
        out.append(Measurement.make("system", metric, value,
                                    source=source, **r))
    return out


# ---------------------------------------------------------------------------
# source 3: zamlet-style synthesis / measurement reports (CSV or JSON)
# ---------------------------------------------------------------------------
def load_report(path: str) -> List[Measurement]:
    """Load measurements from a synthesis/measurement report file.

    Two formats, keyed by extension:

    * ``.json`` — either ``{"rows": [...]}`` or a bare list, each row a dict
      with ``kind``, ``metric``, ``value`` and optional ``source`` plus any
      meta keys (``M``, ``N``, ``K``, ``bw``, ``graph``, ``baseline``, ...).
    * ``.csv``  — header row ``kind,metric,value,source,<meta...>``; empty
      meta cells are skipped, numeric-looking cells are parsed as numbers.

    This mirrors how the zamlet DSE flow ingests OpenLane area/timing
    reports: one row per measured quantity, tool-agnostic columns.
    """
    if path.endswith(".json"):
        with open(path) as f:
            doc = json.load(f)
        rows = doc["rows"] if isinstance(doc, dict) else doc
    elif path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    else:
        raise ValueError(f"unsupported report format: {path!r} "
                         "(expected .json or .csv)")
    out = []
    for i, row in enumerate(rows):
        row = {k: v for k, v in row.items() if v not in (None, "")}
        try:
            kind = row.pop("kind")
            metric = row.pop("metric")
            value = float(row.pop("value"))
        except KeyError as e:
            raise ValueError(f"report row {i} missing column: {e}") from e
        source = row.pop("source", f"report:{path}")
        meta = {k: _coerce(v) for k, v in row.items()}
        out.append(Measurement.make(kind, metric, value, source=source,
                                    **meta))
    return out


def _coerce(v):
    if isinstance(v, str):
        try:
            f = float(v)
            return int(f) if f == int(f) else f
        except ValueError:
            return v
    return v
