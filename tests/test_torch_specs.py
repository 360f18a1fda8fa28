"""The port's input specs against the JAX reference's, on the CPU:

* for every architecture and every cell of ``cells(arch)``, the shapes and
  dtypes of ``launch.specs.input_specs`` equal the reference's
  ``ShapeDtypeStruct`` specs: the parameters through the key map of
  ``convert.lm_params_from_reference`` (a stacked ``blocks`` / ``encoder``
  / ``decoder`` leaf (L, ...) is L port parameters ``blocks.i....``), the
  batch, the cache (dicts in key order), the decode tokens and index;
* every spec lies on meta (nothing allocated), and each cell builds at
  full size in under a second;
* ``launch.train.train_state_specs`` equals the reference's (parameters,
  the two moments, the step count).
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.launch.train import train_state_specs as ref_train_state_specs
from repro.models.model import build_model as ref_build_model
from repro.optim.adamw import AdamWConfig as RefAdamWConfig

from repro_torch.configs import ARCH_IDS, cells, get_config
from repro_torch.launch import specs
from repro_torch.launch.train import train_state_specs
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig

STACKED = ("blocks", "encoder", "decoder")
CELL_SECONDS = 1.0
CELLS = [(a, c) for a in ARCH_IDS for c in cells(a)]


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ref_flat(tree, prefix=""):
    """(dotted name, (shape, dtype)) of a reference pytree of specs, dicts
    by key, tuples by position."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_flat(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _ref_flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], (tuple(tree.shape), jnp.dtype(tree.dtype).name)


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_flat(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _port_flat(v, f"{prefix}{i}.")
    else:
        assert tree.device.type == "meta", prefix
        yield prefix[:-1], (tuple(tree.shape), _dt(tree))


def _ref_params(tree) -> dict:
    """The reference's parameter specs keyed as the port's parameters."""
    out = {}
    for name, (shape, dt) in _ref_flat(tree):
        head, _, rest = name.partition(".")
        if head in STACKED:
            for i in range(shape[0]):
                out[f"{head}.{i}.{rest}"] = (shape[1:], dt)
        else:
            out[name] = (shape, dt)
    return out


def _port_params(module) -> dict:
    out = {}
    for name, p in module.named_parameters():
        assert p.device.type == "meta", name
        out[name] = (tuple(p.shape), _dt(p))
    return out


def test_the_same_architectures_and_cells():
    assert sorted(ARCH_IDS) == sorted(REF_ARCH_IDS)
    assert all(cells(a) == ref_cells(a) for a in ARCH_IDS)


@pytest.mark.parametrize("arch,cell", CELLS, ids=[f"{a}-{c}" for a, c in
                                                 CELLS])
def test_input_specs_match_reference(arch, cell):
    t0 = time.perf_counter()
    got = specs.input_specs(arch, cell)
    built_s = time.perf_counter() - t0
    assert built_s < CELL_SECONDS, built_s
    want = ref_specs.input_specs(arch, cell)
    assert set(got) == set(want)
    assert got["cfg"].name == want["cfg"].name
    assert dataclasses.asdict(got["shape"]) == \
        dataclasses.asdict(want["shape"])
    assert _port_params(got["params"]) == _ref_params(want["params"])
    for key in ("batch", "cache", "tokens", "index"):
        if key in want:
            assert dict(_port_flat(got[key])) == dict(_ref_flat(want[key])), \
                key
    if want["shape"].kind != "train":
        mats = [p for p in got["params"].parameters() if p.dim() >= 2]
        assert mats and all(p.dtype == torch.bfloat16 for p in mats)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "deepseek_v2_236b",
                                  "whisper_tiny", "grok_1_314b"])
def test_train_state_specs_match_reference(arch):
    got = train_state_specs(build_model(get_config(arch), "meta"),
                            AdamWConfig())
    want = ref_train_state_specs(ref_build_model(ref_get_config(arch)),
                                 RefAdamWConfig())
    assert _port_params(got["params"]) == _ref_params(want["params"])
    assert all(p.requires_grad for p in got["params"].parameters())
    for key in ("mu", "nu"):
        assert {n: (tuple(t.shape), _dt(t))
                for n, t in got["opt"][key].items()} \
            == _ref_params(want["opt"][key])
    step = got["opt"]["step"]
    assert (tuple(step.shape), _dt(step), step.device.type) == \
        (tuple(want["opt"]["step"].shape),
         jnp.dtype(want["opt"]["step"].dtype).name, "meta")


def test_specs_allocate_nothing():
    sp = specs.input_specs("grok_1_314b", "decode_32k")
    n = sum(p.numel() for p in sp["params"].parameters())
    assert n > 3e11                         # the full model, on meta
    assert all(p.device.type == "meta" for p in sp["params"].parameters())
    assert sp["index"].shape == () and sp["index"].dtype == torch.int32
    assert np.prod(sp["tokens"].shape) == 128
