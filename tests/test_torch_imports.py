"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro`` —
checked over the source's AST, and in a fresh interpreter through
``sys.modules`` after importing every module of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def _modules():
    return sorted(".".join(("repro_torch",) + p.relative_to(PORT)
                           .with_suffix("").parts).replace(".__init__", "")
                  for p in PORT.rglob("*.py"))


def test_port_has_modules():
    assert len(FILES) > 10 and "repro_torch.explore.api" in _modules()


# the ninth slice: calibration, the flight recorder and the readable model
# references the calibration uses
SLICE_9 = ("repro_torch.core.simulator", "repro_torch.core.mapping",
           "repro_torch.core.perf_model", "repro_torch.obs",
           "repro_torch.obs.metrics", "repro_torch.obs.trace",
           "repro_torch.obs.journal", "repro_torch.obs.report",
           "repro_torch.calib", "repro_torch.calib.measurements",
           "repro_torch.calib.preset", "repro_torch.calib.fit")


@pytest.mark.parametrize("module", SLICE_9)
def test_calibration_and_observability_modules_exist(module):
    assert module in _modules()


# the tenth slice: the async serving shell
SLICE_10 = ("repro_torch.serve", "repro_torch.serve.jobs",
            "repro_torch.serve.executor", "repro_torch.serve.worker")


@pytest.mark.parametrize("module", SLICE_10)
def test_serving_modules_exist(module):
    assert module in _modules()


# the twelfth slice: training
SLICE_12 = ("repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.manager", "repro_torch.runtime",
            "repro_torch.runtime.driver", "repro_torch.runtime.straggler",
            "repro_torch.launch.train")


@pytest.mark.parametrize("module", SLICE_12)
def test_training_modules_exist(module):
    assert module in _modules()


# the fifteenth slice: the front door's tail and the single-card planning
# layer (the kernels' work formulas beside them)
SLICE_15 = ("repro_torch.autosharding", "repro_torch.autosharding.advisor",
            "repro_torch.launch.specs", "repro_torch.launch.graph_analysis",
            "repro_torch.launch.dryrun",
            "repro_torch.kernels.pareto_rank.cost",
            "repro_torch.kernels.gp_cov.cost",
            "repro_torch.kernels.flash_attention.cost",
            "repro_torch.kernels.mamba_scan.cost")


@pytest.mark.parametrize("module", SLICE_15)
def test_planning_modules_exist(module):
    assert module in _modules()


# every kernel launch is an operator of the repro_torch namespace
OPERATORS = ("dominance_counts", "matern52", "flash_attention",
             "flash_attention_fwd_lse", "flash_attention_bwd",
             "selective_scan", "selective_scan_fwd_states",
             "selective_scan_bwd")


@pytest.mark.parametrize("name", OPERATORS)
def test_kernel_operators_are_registered_at_import(name):
    import torch
    from repro_torch.launch import graph_analysis
    op = getattr(torch.ops.repro_torch, name).default
    assert op in graph_analysis.KERNEL_COSTS


def test_front_door_tail_names_exist():
    from repro_torch.core import constants, cost, network, optimizer
    from repro_torch.explore import archive, service
    from repro_torch.models import config
    for mod, name in ((network, "topo_code"), (cost, "monolithic_cost"),
                      (archive, "dominates"), (optimizer, "optimize"),
                      (optimizer, "two_stage_optimize"),
                      (service, "default_service"), (service, "explore"),
                      (constants, "H100Target"), (constants, "DEFAULT_H100"),
                      (config, "ParallelConfig")):
        assert callable(getattr(mod, name)) or name == "DEFAULT_H100", name


def test_runtime_package_keeps_its_names():
    """``runtime.py`` became the package ``runtime/``: every name it
    exported still imports from ``repro_torch.runtime``."""
    from repro_torch import runtime
    for name in ("DEFAULT_DEVICE", "resolve_device", "fold_in", "generator",
                 "LaneGenerators", "rand"):
        assert hasattr(runtime, name), name


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, json, sys, runpy\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='smoke')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        f" in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
