"""Architecture registry of the port: one module per assigned architecture,
the same records as the reference's ``repro/configs``.

``get_config(name)`` returns the full-scale config; ``get_reduced(name)``
the same-family reduced config of the CPU tests and of
``launch/serve.py --reduced``.  ``models.model.build_model`` serves every
one of them.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "deepseek_v2_236b",
    "grok_1_314b",
    "stablelm_1_6b",
    "qwen2_72b",
    "qwen2_5_32b",
    "internlm2_1_8b",
    "whisper_tiny",
    "hymba_1_5b",
    "falcon_mamba_7b",
    "qwen2_vl_72b",
]

# canonical external ids (--arch flag) -> module names
ALIASES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "grok-1-314b": "grok_1_314b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2-72b": "qwen2_72b",
    "qwen2.5-32b": "qwen2_5_32b",
    "internlm2-1.8b": "internlm2_1_8b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells(arch: str) -> List[str]:
    """The shape cells this arch runs (``long_500k`` only for
    sub-quadratic archs)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
