"""The reference transfer benchmark's two gates (``benchmarks/
bench_transfer.py``: (a) transfer, (b) warm refinement), key by key, for
the JAX reference and for the port on the CPU, through the arms that
``chip_smoke.py`` phase 12 runs on the card (``chip_smoke.transfer_arms``):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_transfer_gates.py \\
        gates 4096 100-119 [reference,port] > gates.jsonl

prints one JSON line a key and package (the ``transfer_arms`` readings).

    python tests/torch_transfer_gates.py summary gates.jsonl

then prints, for each package in the file, how many keys meet each gate
alone with the mean and standard deviation of its hypervolume ratio, and
bootstraps the chance that K keys drawn from that package's lines pass
phase 12's gates as ``chip_smoke.pooled_gates`` holds them.  Not a test:
a tool for reading the gates' statistics (about a minute a key and
package at B = 4096).
"""

import contextlib
import functools
import json
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _package(name: str) -> cs.Package:
    if name == "port":
        return cs.Package(functools.partial(cs.Session, device="cpu"),
                          cs.Query, cs.Problem, cs.NSGAConfig,
                          cs.BudgetPolicy, cs.ManifestPolicy,
                          cs.presets.workload_library, sync=lambda: None)
    import jax
    import repro.api as api
    from repro.core import presets
    from repro.explore.archive import ManifestPolicy
    from repro.explore.nsga import NSGAConfig
    from repro.explore.service import BudgetPolicy
    return cs.Package(api.Session, api.Query, api.Problem, NSGAConfig,
                      BudgetPolicy, ManifestPolicy, presets.workload_library,
                      key=jax.random.PRNGKey, sync=lambda: None)


def gates(budget: int, keys, packages):
    pkgs = {name: _package(name) for name in packages}
    for key in keys:
        for name, pkg in pkgs.items():
            with tempfile.TemporaryDirectory() as tmp, \
                    contextlib.redirect_stdout(sys.stderr):
                out, _ = cs.transfer_arms(Path(tmp), key, budget, pkg)
            print(json.dumps(dict(package=name, budget=budget, **out)),
                  flush=True)


def summary(rows, ks=(3, 4, 5, 6), draws=4000):
    rng = np.random.default_rng(0)
    for name in sorted({r["package"] for r in rows}):
        mine = [r for r in rows if r["package"] == name]
        line = dict(package=name, keys=len(mine))
        for g in ("gate", "refine_gate"):
            ratio = np.array([r[g]["hv_ratio"] for r in mine])
            line[g] = dict(alone=sum(r[g]["passes_alone"] for r in mine),
                           ratio_mean=ratio.mean(),
                           ratio_sd=ratio.std(ddof=1))
        print(json.dumps(line))
        for K in ks:
            res = np.array([
                [v["passes"] for v in cs.pooled_gates(
                    [mine[i] for i in rng.choice(len(mine), K,
                                                 replace=False)])]
                for _ in range(draws)])
            print(json.dumps(dict(package=name, pooled_keys=K,
                                  a=res[:, 0].mean(), b=res[:, 1].mean(),
                                  both=(res[:, 0] & res[:, 1]).mean())))


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
