"""Standalone job-store worker: ``python -m repro_torch.serve.worker`` (the
port's copy of ``repro.serve.worker``).

Drains a durable ``JobStore`` in its own process — the multi-process
face of the serving layer.  Any number of workers (and in-process
``Executor``s) can point at one store + cache directory: claims are
lock-arbitrated, archive/manifest writes reload-merge under file locks,
and every job runs with ``resume=True``, so a worker killed mid-segment
(power loss, OOM, SIGKILL) leaves a checkpoint a successor restores —
the re-run spends only the residual budget and lands on the
bit-identical final front.

    python -m repro_torch.serve.worker --store DIR --cache DIR [--once]
        [--poll S] [--segment-delay S] [--pop N]
        [--chunk-generations N] [--no-adaptive] [--tech PRESET]
        [--device {cuda,cpu}]

``--once`` drains the currently-pending jobs and exits (CI / tests);
without it the worker polls forever.  The engine knobs (``--pop`` /
``--chunk-generations`` / ``--no-adaptive``) must match across the
workers of one store — the resume checkpoint's signature folds the
engine configuration in, so a mismatched successor falls back to a
fresh run instead of restoring a foreign checkpoint.
``--segment-delay`` sleeps inside every segment callback — it exists to
widen the kill window so the crash-resume e2e test can SIGKILL
deterministically mid-run.  One JSON line per finished job goes to
stdout (id, state, attempt ledger, front size), after one ``RECOVERED``
line per job recovered from a dead owner.

``--device`` (default ``cuda``) is where the worker's session searches;
without a card the worker exits non-zero with the device error unless
``--device cpu`` is given.  A checkpoint's signature folds the device type
in, so a worker on the other device restarts such a job instead of
resuming it.  Start workers as fresh interpreters (``subprocess``), never
as a ``fork`` of a process that has touched CUDA."""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..explore.api import Session
from .executor import run_job
from .jobs import JobStore


def _drain(session: Session, store: JobStore, segment_delay: float) -> int:
    """Claim-and-run every currently-pending job; returns how many this
    worker actually won (other workers may steal from under us — that is
    the arbitration working, not an error)."""
    on_segment = (lambda ev: time.sleep(segment_delay)) \
        if segment_delay > 0 else None
    n = 0
    for rec in store.pending():
        claimed = store.claim(rec.job_id)
        if claimed is None:
            continue
        try:
            res = run_job(session, store, claimed, on_segment=on_segment)
        except Exception:
            res = None              # run_job already journaled FAILED
        final = store.get(rec.job_id)
        print(json.dumps(dict(
            job=rec.job_id, state=final.state if final else "?",
            attempts=final.attempts if final else None,
            n_evals_attempts=final.n_evals_attempts if final else None,
            front_size=int(len(res.front_objs)) if res is not None
            else None)), flush=True)
        n += 1
    return n


def _session(args) -> Session:
    kwargs = {}
    if args.pop or args.chunk_generations or args.no_adaptive:
        from ..explore.nsga import NSGAConfig
        from ..explore.service import BudgetPolicy
        if args.pop:
            kwargs["nsga"] = NSGAConfig(pop=args.pop, generations=2)
        kwargs["policy"] = BudgetPolicy(
            chunk_generations=args.chunk_generations or 8,
            adaptive=not args.no_adaptive)
    if args.tech:
        kwargs["tech"] = args.tech
    return Session(cache_dir=args.cache, device=args.device, **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.worker",
        description="drain a repro_torch.serve job store")
    ap.add_argument("--store", required=True,
                    help="job store directory (one JSON file per job)")
    ap.add_argument("--cache", required=True,
                    help="shared archive cache directory")
    ap.add_argument("--once", action="store_true",
                    help="drain currently-pending jobs, then exit")
    ap.add_argument("--poll", type=float, default=0.2,
                    help="idle poll interval in seconds")
    ap.add_argument("--pop", type=int, default=0,
                    help="NSGA population override")
    ap.add_argument("--chunk-generations", type=int, default=0,
                    help="BudgetPolicy.chunk_generations override")
    ap.add_argument("--no-adaptive", action="store_true",
                    help="disable plateau early-stopping")
    ap.add_argument("--tech", default="",
                    help="tech preset for this worker's session: a name "
                         "registered under $REPRO_CALIB_DIR or a "
                         "CalibratedTech JSON artifact path (default: "
                         "the uncalibrated constants; per-query tech "
                         "names still resolve either way)")
    ap.add_argument("--segment-delay", type=float, default=0.0,
                    help="sleep this long in every segment callback "
                         "(test hook: widens the crash window)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the searches run (default: the card)")
    args = ap.parse_args(argv)

    store = JobStore(args.store)
    try:
        session = _session(args)
    except RuntimeError as e:           # no card and no --device cpu
        print(f"{ap.prog}: {e}", file=sys.stderr)
        return 2
    for rec in store.recover():
        print(json.dumps(dict(job=rec.job_id, state="RECOVERED",
                              attempts=rec.attempts)), flush=True)
    while True:
        n = _drain(session, store, args.segment_delay)
        if args.once:
            return 0
        if n == 0:
            time.sleep(args.poll)


if __name__ == "__main__":
    sys.exit(main())
