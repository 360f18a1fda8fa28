"""The reference surrogate benchmark's gates (``benchmarks/
bench_surrogate.py``), key by key, for the JAX reference and for the port
on the CPU, through the arms that ``chip_smoke.py`` phase 13 (b) runs on
the card (``chip_smoke.surrogate_arms``):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_surrogate_gates.py \\
        gates 4096 100-119 [reference,port] > gates.jsonl

prints one JSON line a key and package (the ``surrogate_arms`` readings).

    python tests/torch_surrogate_gates.py summary gates.jsonl

then prints, for each package in the file, how many keys meet the gates
alone (hypervolume >= 0.99 x the exact arm's, exact spend <= 50%, every
skipped candidate accounted for), the mean and standard deviation of the
hypervolume ratio, and bootstraps the chance that K keys drawn from that
package's lines pass ``chip_smoke.pooled_surrogate_gate``.  Not a test: a
tool for reading the gates' statistics.
"""

import contextlib
import json
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_transfer_gates import _package  # noqa: E402


def gates(budget: int, keys, packages):
    pkgs = {name: _package(name) for name in packages}
    for key in keys:
        for name, pkg in pkgs.items():
            with tempfile.TemporaryDirectory() as tmp, \
                    contextlib.redirect_stdout(sys.stderr):
                out = cs.surrogate_arms(Path(tmp), key, budget, pkg)
            print(json.dumps(dict(package=name, budget=budget, **out)),
                  flush=True)


def summary(rows, ks=(1, 3, 5), draws=4000):
    rng = np.random.default_rng(0)
    for name in sorted({r["package"] for r in rows}):
        mine = [r for r in rows if r["package"] == name]
        ratio = np.array([r["gate"]["hv_ratio"] for r in mine])
        print(json.dumps(dict(
            package=name, keys=len(mine),
            alone=sum(r["gate"]["passes_alone"] for r in mine),
            hv_alone=int(np.sum(ratio >= cs.SUR_HV_GATE)),
            fallbacks=sum(r["gate"]["fallbacks"] for r in mine),
            ratio_mean=ratio.mean(), ratio_sd=ratio.std(ddof=1),
            ratio_min=ratio.min())))
        for K in ks:
            res = [cs.pooled_surrogate_gate(
                [mine[i] for i in rng.choice(len(mine), K, replace=False)]
            )["passes"] for _ in range(draws)]
            print(json.dumps(dict(package=name, pooled_keys=K,
                                  passes=float(np.mean(res)))))


def main(argv):
    warnings.filterwarnings("ignore")
    if argv[:1] == ["gates"] and len(argv) >= 3:
        lo, hi = (int(v) for v in argv[2].split("-"))
        packages = argv[3].split(",") if len(argv) > 3 \
            else ("reference", "port")
        gates(int(argv[1]), range(lo, hi + 1), packages)
    elif argv[:1] == ["summary"] and len(argv) == 2:
        summary([json.loads(line) for line in open(argv[1])])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
