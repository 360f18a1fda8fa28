"""Journal reporting CLI: plan-vs-actual tables and a fleet summary.

    python -m repro_torch.obs.report <journal.jsonl | journal-dir> [key-prefix]

For every ``plan`` record in the journal, renders the predicted
``SegmentPlan`` schedule against what the run actually did — per-segment
wall-clock (first-call/compile segments flagged), evaluations, and the
archive-projected hypervolume trajectory.  Planned segments with no
observation render as ``-`` (the plateau detector stopped the run
early); reallocation top-ups appear under their own phase.  A fleet
summary follows: query count, cache hit rate, evaluations/second, and
exact p50/p90/p99 time-to-front over the journaled results.

``render(records)`` returns the report as a string (what ``bench_obs``
gates on); ``main`` prints it.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

from .journal import read_journal


def _fmt(v, width: int = 10, prec: int = 4) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{prec}g}".rjust(width)
    return str(v).rjust(width)


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[max(idx, 0)]


def _blocks(records: Sequence[Dict], key_prefix: str = ""):
    """Walk the record stream in order, pairing each ``plan`` record with
    the ``refine``-phase segments that executed it (the segments of that
    key until its next plan); ``realloc`` segments attach to the key's
    most recent block.  Returns (blocks, results, last metrics snapshot)."""
    blocks: List[Dict] = []
    current: Dict[str, Dict] = {}       # key -> its open block
    results: List[Dict] = []
    metrics: Optional[Dict] = None
    for rec in records:
        typ = rec.get("type")
        key = rec.get("key", "")
        if key_prefix and isinstance(key, str) \
                and not key.startswith(key_prefix) and typ != "metrics":
            continue
        if typ == "plan":
            blk = dict(plan=rec, refine=[], realloc=[])
            blocks.append(blk)
            current[key] = blk
        elif typ == "segment":
            blk = current.get(key)
            if blk is None:             # segments with no plan record
                blk = dict(plan=None, key=key, refine=[], realloc=[])
                blocks.append(blk)
                current[key] = blk
            phase = rec.get("phase", "refine")
            blk["realloc" if phase == "realloc" else "refine"].append(rec)
        elif typ == "result":
            results.append(rec)
        elif typ == "metrics":
            metrics = rec.get("snapshot", rec)
    return blocks, results, metrics


def _render_block(blk: Dict, out: List[str]) -> None:
    plan = blk.get("plan")
    key = (plan or blk).get("key", "?")
    head = f"problem {key}"
    if plan is not None:
        head += (f"  engine={plan.get('engine')} "
                 f"budget={plan.get('budget')} "
                 f"cache_hit={plan.get('cache_hit')}")
    out.append(head)
    planned = list((plan or {}).get("segments") or [])
    observed = {int(s.get("segment", -1)): s for s in blk["refine"]}
    if plan is not None and plan.get("cache_hit") and not planned:
        out.append("  (warm serve: no segments planned, none run)")
    if planned or observed:
        out.append("  phase    seg  pop  gens  plan_evals    actual_s"
                   "  compile          hv  front")
        idx = sorted(set(range(len(planned))) | set(observed))
        for i in idx:
            p = planned[i] if i < len(planned) else None
            o = observed.get(i)
            hv = (o or {}).get("hv") or []
            out.append(
                "  refine " + _fmt(i, 5)
                + _fmt(p and p.get("pop"), 5)
                + _fmt(p and p.get("generations"), 6)
                + _fmt(p and p.get("n_evals"), 12)
                + _fmt(o and float(o.get("elapsed_s", 0.0)), 12)
                + _fmt("*" if (o or {}).get("compile") else "", 9)
                + _fmt(float(hv[0]) if hv else None, 12)
                + _fmt(o and o.get("front_size"), 7))
        for s in blk["realloc"]:
            hv = s.get("hv") or []
            out.append(
                "  realloc" + _fmt(int(s.get("segment", -1)), 5)
                + _fmt(None, 5) + _fmt(None, 6) + _fmt(None, 12)
                + _fmt(float(s.get("elapsed_s", 0.0)), 12)
                + _fmt("*" if s.get("compile") else "", 9)
                + _fmt(float(hv[0]) if hv else None, 12)
                + _fmt(s.get("front_size"), 7))
    if plan is not None and plan.get("neighbors"):
        for n in plan["neighbors"]:
            out.append(f"  seed<- {n.get('key')}  "
                       f"dist={n.get('distance'):.4g} "
                       f"quota={n.get('quota')}")
    out.append("")


def render(records: Sequence[Dict], key_prefix: str = "") -> str:
    """The full report over an in-memory record list."""
    records = list(records)
    blocks, results, metrics = _blocks(records, key_prefix)
    out: List[str] = ["== plan vs actual =="]
    if not blocks:
        out.append("(no planned or executed runs in journal)")
        out.append("")
    for blk in blocks:
        _render_block(blk, out)

    out.append("== fleet summary ==")
    n = len(results)
    hits = sum(1 for r in results if r.get("from_cache"))
    evals = sum(int(r.get("n_evals", 0)) for r in records
                if r.get("type") == "segment")
    seg_s = sum(float(r.get("elapsed_s", 0.0)) for r in records
                if r.get("type") == "segment")
    ttf = sorted(float(r.get("elapsed_s", 0.0)) for r in results)
    out.append(f"queries={n}  cache_hits={hits}"
               + (f" (hit rate {hits / n:.2f})" if n else ""))
    out.append(f"evals={evals}  segment_s={seg_s:.3f}"
               + (f"  evals/sec={evals / seg_s:.1f}" if seg_s > 0 else ""))
    out.append("time-to-front"
               + f"  p50={_fmt(_quantile(ttf, 0.50), 0)}s"
               + f"  p90={_fmt(_quantile(ttf, 0.90), 0)}s"
               + f"  p99={_fmt(_quantile(ttf, 0.99), 0)}s")
    if metrics:
        interesting = ("obs.on_segment_errors", "obs.sink_errors",
                       "explore.cache.hit", "explore.cache.miss",
                       "explore.plateau_stops",
                       "explore.manifest.reloads",
                       "explore.manifest.evictions",
                       "explore.transfer.seeds_injected",
                       "explore.transfer.seeds_deduped")
        parts = [f"{k.split('.', 1)[1]}={metrics[k]['value']}"
                 for k in interesting if k in metrics]
        if parts:
            out.append("counters: " + "  ".join(parts))
    return "\n".join(out) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    key_prefix = argv[1] if len(argv) > 1 else ""
    print(render(list(read_journal(argv[0])), key_prefix), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
