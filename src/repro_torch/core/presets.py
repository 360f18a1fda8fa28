"""Workload suites used by the paper's experiments (graph builders only).

* res[2-5]  — the ``res{2,3,4,5}b_branch2b`` 3x3 convolutions of ResNet-50
  (paper Fig. 7, batch 1).
* att[1-4]  — four matrix-multiply shapes from BERT-large (seq 512, hidden
  1024, heads 16, FFN 4096): QKV projection, QK^T scores, scores x V, FFN.
* transformer_block — Fig. 4a: 2 heads = 5 matmuls with the 0->2, 1->3,
  2->4, 3->4 dependency structure, pipelineable across chiplets.
* tt_chain  — Fig. 10: tensor-train contraction chain C23 -> C33 -> C43 -> C52.
* workload_library — 8 workload graphs derived from the registered
  ``repro_torch.configs`` architectures (attention blocks, MLP stacks, a
  conv chain, scan-style contraction chains): the scenario-diverse library
  the cross-workload transfer path is exercised on.

The same builders as ``repro.core.presets``, and the same named
``TechConstants`` presets (``register_tech`` / ``tech_preset`` /
``resolve_tech`` / ``tech_label``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

from .constants import DEFAULT_TECH, TechConstants, tech_from_dict, tech_key
from .workload import (Edge, WorkloadGraph, contraction, conv2d, matmul,
                       mttkrp)


def resnet_convs() -> Dict[str, WorkloadGraph]:
    """res{2-5}b_branch2b: 3x3 stride-1 convs at each ResNet-50 stage."""
    shapes = {
        "res2": dict(N=1, K=64, C=64, P=56, Q=56, R=3, S=3),
        "res3": dict(N=1, K=128, C=128, P=28, Q=28, R=3, S=3),
        "res4": dict(N=1, K=256, C=256, P=14, Q=14, R=3, S=3),
        "res5": dict(N=1, K=512, C=512, P=7, Q=7, R=3, S=3),
    }
    return {k: WorkloadGraph([conv2d(k, **v)], []) for k, v in shapes.items()}


def bert_mms() -> Dict[str, WorkloadGraph]:
    """Four matmul shapes from BERT-large."""
    shapes = {
        "att1": (512, 1024, 1024),   # QKV projection
        "att2": (512, 512, 64),      # per-head Q K^T
        "att3": (512, 64, 512),      # per-head scores x V
        "att4": (512, 4096, 1024),   # FFN up-projection
    }
    return {k: WorkloadGraph([matmul(k, *v)], []) for k, v in shapes.items()}


def fig7_suite() -> Dict[str, WorkloadGraph]:
    out = dict(resnet_convs())
    out.update(bert_mms())
    return out


def transformer_block(seq: int = 512, d: int = 512,
                      heads: int = 2) -> WorkloadGraph:
    """Paper Fig. 4a: 2 heads / 5 matmuls with cross-head concat into MM4."""
    dh = d // heads
    wls = [
        matmul("mm0_qk_h0", seq, seq, dh),
        matmul("mm1_qk_h1", seq, seq, dh),
        matmul("mm2_av_h0", seq, dh, seq),
        matmul("mm3_av_h1", seq, dh, seq),
        matmul("mm4_out", seq, d, d),
    ]
    edges = [
        Edge(0, 2, "C", "A"),
        Edge(1, 3, "C", "A"),
        Edge(2, 4, "C", "A"),
        Edge(3, 4, "C", "A"),
    ]
    return WorkloadGraph(wls, edges)


def tt_chain(s: int = 32, r: int = 32) -> WorkloadGraph:
    """Fig. 10: TT reconstruction by sequential contraction.  The result
    tensor grows: C23 (O(n^4)) -> C33 (O(n^5)) -> C43/C52 (O(n^6))."""
    c23 = contraction("c23", {"s1": s}, {"s2": s, "a2": r}, {"a1": r})
    c33 = contraction("c33", {"m": s * s}, {"s3": s, "a3": r}, {"a2": r})
    c43 = contraction("c43", {"m": s * s * s}, {"s4": s, "a4": r}, {"a3": r})
    c52 = contraction("c52", {"m": s * s * s * s}, {"s5": s}, {"a4": r})
    edges = [
        Edge(0, 1, "O", "A"),
        Edge(1, 2, "O", "A"),
        Edge(2, 3, "O", "A"),
    ]
    return WorkloadGraph([c23, c33, c43, c52], edges)


def validation_suite() -> Dict[str, WorkloadGraph]:
    """Small matmuls for the Sec. V-A model-vs-simulator validation (the
    paper uses a four-chip transformer with 8x8 PE arrays per chip)."""
    out = {}
    for m, n, k in [(64, 64, 64), (128, 128, 128), (128, 512, 256),
                    (256, 256, 256), (512, 512, 128)]:
        out[f"mm{m}x{n}x{k}"] = WorkloadGraph([matmul("mm", m, n, k)], [])
    return out


def mttkrp_example(i: int = 256, j: int = 64, k: int = 128,
                   l: int = 128) -> WorkloadGraph:
    return WorkloadGraph([mttkrp("mttkrp", i, j, k, l)], [])


# ---------------------------------------------------------------------------
# model-derived workload library (cross-workload transfer scenarios)
# ---------------------------------------------------------------------------
def attention_block(cfg, seq: int = 256) -> WorkloadGraph:
    """One self-attention block of a registered architecture: QKV
    projection -> per-head QK^T -> scores x V -> output projection, chained
    producer->consumer (per-head matmuls at head_dim width)."""
    d, hd = cfg.d_model, cfg.head_dim
    qkv_cols = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    wls = [
        matmul("qkv_proj", seq, qkv_cols, d),
        matmul("qk_scores", seq, seq, hd),
        matmul("av", seq, hd, seq),
        matmul("out_proj", seq, d, cfg.n_heads * hd),
    ]
    edges = [Edge(0, 1, "C", "A"), Edge(1, 2, "C", "A"), Edge(2, 3, "C", "A")]
    return WorkloadGraph(wls, edges)


def mlp_stack(cfg, seq: int = 256) -> WorkloadGraph:
    """Gated MLP of a registered architecture (MoE archs use the per-expert
    width): gate and up projections feeding the down projection."""
    d = cfg.d_model
    ff = cfg.expert_ff if cfg.n_experts > 0 else cfg.d_ff
    wls = [
        matmul("gate_proj", seq, ff, d),
        matmul("up_proj", seq, ff, d),
        matmul("down_proj", seq, d, ff),
    ]
    edges = [Edge(0, 2, "C", "A"), Edge(1, 2, "C", "B")]
    return WorkloadGraph(wls, edges)


def conv_frontend(cfg, frames: int = 1500, mel: int = 80) -> WorkloadGraph:
    """Whisper-style audio conv frontend: two stride-adjacent k=3 conv1d
    layers (encoded as 7-loop conv2d with a unit Q axis)."""
    d = cfg.d_model
    c1 = conv2d("conv1", N=1, K=d, C=mel, P=frames, Q=1, R=3, S=1)
    c2 = conv2d("conv2", N=1, K=d, C=d, P=frames // 2, Q=1, R=3, S=1)
    return WorkloadGraph([c1, c2], [Edge(0, 1, "O", "I")])


def scan_chain(cfg, seq: int = 512) -> WorkloadGraph:
    """Mamba-style selective-scan dataflow as a contraction chain:
    in-projection -> state contraction -> output projection."""
    d, di, n = cfg.d_model, cfg.d_inner, max(cfg.ssm_state, 1)
    c_in = contraction("in_proj", {"t": seq}, {"di": di}, {"d": d})
    c_h = contraction("state", {"t": seq}, {"n": n}, {"di": di})
    c_out = contraction("out_proj", {"t": seq}, {"dm": d}, {"n": n})
    return WorkloadGraph([c_in, c_h, c_out],
                         [Edge(0, 1, "O", "A"), Edge(1, 2, "O", "A")])


def hybrid_block(cfg, seq: int = 256) -> WorkloadGraph:
    """Hymba-style parallel heads: sliding-window attention (scores over a
    ``window`` span) beside an SSM state contraction, both feeding one
    output projection."""
    d, hd = cfg.d_model, cfg.head_dim
    w = cfg.window or seq
    di, n = cfg.d_inner, max(cfg.ssm_state, 1)
    wls = [
        matmul("win_scores", seq, min(w, seq), hd),
        matmul("win_av", seq, hd, min(w, seq)),
        contraction("ssm", {"t": seq}, {"n": n}, {"di": di}),
        matmul("out_proj", seq, d, d),
    ]
    edges = [Edge(0, 1, "C", "A"), Edge(1, 3, "C", "A"),
             Edge(2, 3, "O", "B")]
    return WorkloadGraph(wls, edges)


def workload_library() -> Dict[str, WorkloadGraph]:
    """Scenario-diverse workload graphs derived from the registered
    architectures: similar pairs (the three attention blocks; the two MLPs)
    beside structurally alien ones (conv vs. scan vs. attention)."""
    from ..configs import get_config       # lazy: keep repro_torch.core light
    qwen72 = get_config("qwen2_72b")
    qwen32 = get_config("qwen2_5_32b")
    intern = get_config("internlm2_1_8b")
    deepseek = get_config("deepseek_v2_236b")
    whisper = get_config("whisper_tiny")
    mamba = get_config("falcon_mamba_7b")
    hymba = get_config("hymba_1_5b")
    return {
        "attn_qwen2_72b": attention_block(qwen72),
        "attn_qwen2_5_32b": attention_block(qwen32),
        "attn_internlm2": attention_block(intern),
        "mlp_qwen2_72b": mlp_stack(qwen72),
        "mlp_deepseek_v2": mlp_stack(deepseek),
        "conv_whisper": conv_frontend(whisper),
        "scan_falcon_mamba": scan_chain(mamba),
        "hybrid_hymba": hybrid_block(hymba),
    }


# ---------------------------------------------------------------------------
# Technology presets — named TechConstants variants, including calibrated
# artifacts (a JSON tech dict, or {"name": ..., "tech": {...}})
# ---------------------------------------------------------------------------
_TECH_PRESETS: Dict[str, TechConstants] = {"default": DEFAULT_TECH}


def register_tech(name: str, tech: TechConstants) -> None:
    """Register a named TechConstants preset for this process.
    Re-registering a name with different constants is an error (a preset's
    identity stays stable within a process); identical constants are a
    no-op."""
    prev = _TECH_PRESETS.get(name)
    if prev is not None and prev != tech:
        raise ValueError(f"tech preset {name!r} already registered with "
                         "different constants")
    _TECH_PRESETS[name] = tech


def tech_preset_names() -> tuple:
    return tuple(sorted(_TECH_PRESETS))


def _load_tech_file(path: str) -> Tuple[str, TechConstants]:
    """Load a tech preset from a JSON file: either a bare tech dict or a
    calibrated-tech artifact ({"name": ..., "tech": {...}})."""
    with open(path) as f:
        doc = json.load(f)
    if "tech" in doc and isinstance(doc["tech"], dict):
        name = doc.get("name") or os.path.splitext(os.path.basename(path))[0]
        return str(name), tech_from_dict(doc["tech"])
    name = os.path.splitext(os.path.basename(path))[0]
    return name, tech_from_dict(doc)


def tech_preset(name: str) -> TechConstants:
    """Resolve a tech preset by name: the in-process registry
    (``register_tech``), then ``$REPRO_CALIB_DIR/<name>.json``, then
    ``name`` as a path to a JSON artifact.  File-resolved presets are
    registered, so a name maps to one set of constants per process."""
    if name in _TECH_PRESETS:
        return _TECH_PRESETS[name]
    cal_dir = os.environ.get("REPRO_CALIB_DIR", "")
    candidates = []
    if cal_dir:
        candidates.append(os.path.join(cal_dir, f"{name}.json"))
    if name.endswith(".json") or os.sep in name:
        candidates.append(name)
    for path in candidates:
        if os.path.exists(path):
            _, tech = _load_tech_file(path)
            register_tech(name, tech)
            return tech
    raise KeyError(
        f"unknown tech preset {name!r}; known: {tech_preset_names()} "
        "(set REPRO_CALIB_DIR or pass a JSON artifact path)")


def resolve_tech(tech) -> Tuple[str, TechConstants]:
    """Normalize any accepted tech designator to ``(name, TechConstants)``:
    ``None`` (the default constants), a preset name or artifact path, a
    ``TechConstants``, or a calibrated tech (duck-typed: ``.name`` and
    ``.tech`` attributes)."""
    if tech is None:
        return "default", DEFAULT_TECH
    if isinstance(tech, str):
        return tech, tech_preset(tech)
    if isinstance(tech, TechConstants):
        if tech == DEFAULT_TECH:
            return "default", tech
        for name, t in _TECH_PRESETS.items():
            if t == tech:
                return name, tech
        return "custom", tech
    name = getattr(tech, "name", None)
    inner = getattr(tech, "tech", None)
    if isinstance(inner, TechConstants) and name:
        register_tech(str(name), inner)
        return str(name), inner
    raise TypeError(f"cannot resolve tech designator of type {type(tech)!r}")


def tech_label(tech) -> str:
    """Tech identity ``name@digest12`` carried in provenance; plain
    ``"default"`` for the uncalibrated constants."""
    name, t = resolve_tech(tech)
    if t == DEFAULT_TECH:
        return "default"
    return f"{name}@{tech_key(t)[:12]}"
