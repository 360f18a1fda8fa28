"""Monad as autosharder: the port of the reference's
``repro/autosharding/advisor.py``, priced on the H100
(``core.constants.DEFAULT_H100``).

The paper co-designs *architecture* (per-workload resources + dataflow)
with *integration* (network + packaging) through an analytical model and a
BO engine.  At cluster scale the same objects are: the parallelism layout
(mesh factorization, FSDP/TP/EP/PP assignment, microbatching, remat,
decode-cache layout) co-designed against the interconnect.  This module:

* defines the layout design space (``ShardPlan``),
* scores a plan with a Monad-style three-term analytical model (compute /
  HBM / links — the same non-uniformity decomposition as Sec. III-C, with
  the GPipe bubble playing the role of the paper's pipeline-stall term),
* searches it with the SAME GP+PI Bayesian machinery as the chiplet DSE
  (``repro_torch.core.optimizer``: on the card its covariance is the
  ``gp_cov`` kernel), exhaustive enumeration being the ground truth the
  BO run is benchmarked against.

Every function takes ``target=`` (an ``H100Target``; the reference's
``tpu=``): one card's peak, HBM rate and capacity, and its links.  The
collective term prices each group on its tier (``H100Target``):
the mesh is laid out model-innermost, then data, then stage, so a TP
group spans ``tp`` consecutive ranks, an FSDP / data group ``tp * dp`` and
a pipeline hop ``tp * dp * pp``; a group within one node of
``node_gpus`` cards moves on NVLink, a larger one on the network.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.constants import DEFAULT_H100, H100Target
from ..core.optimizer import gp_posterior, prob_improvement
from ..models.config import ModelConfig, ShapeConfig
from ..runtime import resolve_device

REMAT_MULT = {"none": 1.0, "dots": 1.18, "full": 4.0 / 3.0}


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    data: int                    # mesh data-axis extent (x pods implicitly)
    model: int                   # mesh model-axis extent (TP)
    microbatch: int = 1
    remat: str = "full"
    fsdp: bool = True            # ZeRO-3 weight sharding over data
    decode_kv: str = "sequence"  # sequence | heads
    pipeline_stages: int = 1     # PP over layer groups (GPipe)
    seq_shard: bool = False

    def chips(self, pods: int = 1) -> int:
        return pods * self.data * self.model * self.pipeline_stages


@dataclasses.dataclass
class PlanScore:
    compute_s: float
    memory_s: float
    collective_s: float
    bubble_frac: float
    hbm_gb: float
    feasible: bool
    step_s: float

    def to_dict(self):
        return dataclasses.asdict(self)


def predict(cfg: ModelConfig, sc: ShapeConfig, plan: ShardPlan,
            pods: int = 1,
            target: H100Target = DEFAULT_H100) -> PlanScore:
    """Analytical three-term score of a layout (Monad Sec. III-C at
    cluster scale) on ``target``'s cards.  Deliberately simple closed
    forms — the point is correct *ranking*, validated against dry-run
    artifacts."""
    N = cfg.active_param_count()
    P_all = cfg.param_count()
    chips = plan.chips(pods)
    dp = pods * plan.data
    tp = plan.model
    pp = plan.pipeline_stages
    L = max(cfg.n_layers, 1)
    d = cfg.d_model
    B, S = sc.global_batch, sc.seq_len
    bpe = 2.0
    peak = target.peak_bf16_tflops * 1e12
    hbm = target.hbm_gbps * 1e9
    ici = target.links_per_chip * target.link_gbps * 1e9
    # wire bytes a card sends inside one node (``wire``) and across nodes
    # (``wire_net``), each added in the reference's order; a group spans
    # more than one node when its ranks spread over more than node_gpus
    wire = wire_net = 0.0
    net_tp, net_dp, net_pp = (n > target.node_gpus
                              for n in (tp, tp * dp, tp * dp * pp))

    def add(w, net):
        nonlocal wire, wire_net
        if net:
            wire_net += w
        else:
            wire += w

    if sc.kind == "train":
        tokens = B * S
        flops = 6.0 * N * tokens
        # attention quadratic term (full-attention archs)
        if cfg.n_heads and not cfg.subquadratic:
            flops += 3.0 * 4.0 * B * S * S * cfg.n_heads * cfg.head_dim * L
        flops *= REMAT_MULT[plan.remat]
        passes = 2.0 + (1.0 if plan.remat != "none" else 0.0)
        m = plan.microbatch
        # HBM: weights stream per microbatch per pass + activation dots I/O
        w_local = P_all * bpe / (tp * pp) / (dp if not plan.fsdp else 1.0)
        w_traffic = (P_all * bpe / (tp * pp)) * m * passes
        act = tokens / dp / m * d * bpe
        act_traffic = act * L / pp * 14.0 * passes * m
        mem_bytes = w_traffic + act_traffic + 3 * P_all * 4.0 / chips
        # ICI: FSDP gathers + grad reduce-scatter + TP all-reduces (+EP a2a)
        if plan.fsdp and dp > 1:
            add((P_all * bpe / (tp * pp)) * (dp - 1) / dp * m * passes,
                net_dp)
            add(2.0 * (P_all * 4.0 / (tp * pp)) * (dp - 1) / dp, net_dp)
        elif dp > 1:
            add(2.0 * (P_all * 4.0 / (tp * pp)) * (dp - 1) / dp, net_dp)
        if tp > 1:
            add(2.0 * 2.0 * act * m * L / pp * (tp - 1) / tp * passes,
                net_tp)
        if cfg.n_experts:
            a2a = tokens / dp * cfg.top_k * d * bpe
            add(2.0 * a2a * L / pp * (tp - 1) / tp * passes / tp, net_tp)
        if pp > 1:
            add(act * m * (pp - 1) / pp * passes, net_pp)
        bubble = (pp - 1) / (m + pp - 1) if pp > 1 else 0.0
        # params f32 + bf16 moments + f32 grads = 12 B/param, ZeRO-sharded;
        # + sqrt(L) saved layer boundaries (grouped remat) per microbatch
        hbm_need = (P_all * 12.0 / chips + math.sqrt(L) * act * 2.0)
    else:
        tokens = B * S if sc.kind == "prefill" else B
        flops = 2.0 * N * tokens
        if cfg.n_heads and not cfg.subquadratic:
            ctx = S
            flops += 4.0 * B * (S * S if sc.kind == "prefill" else ctx) \
                * cfg.n_heads * cfg.head_dim * L
        cache = _cache_bytes(cfg, sc)
        # weights + cache stream once per step, sharded across all chips
        mem_bytes = (2.0 * N + cache) / chips
        act = tokens / max(dp, 1) * d * bpe
        if tp > 1:
            add(2.0 * 2.0 * act * L * (tp - 1) / tp, net_tp)
        if sc.kind == "decode" and plan.decode_kv == "sequence" and tp > 1:
            # flash-decoding partial-softmax combine per layer
            add(2.0 * B / max(dp, 1) * cfg.n_heads * (cfg.head_dim + 2)
                * 4.0 * L * (tp - 1) / tp, net_tp)
        bubble = 0.0
        m = 1
        hbm_need = 2.0 * P_all / chips + cache / chips

    # mem_bytes and wire are PER-DEVICE totals by construction above
    compute_s = flops / chips / peak / max(1.0 - bubble, 1e-3)
    memory_s = mem_bytes / hbm if sc.kind == "train" else mem_bytes / hbm
    collective_s = wire / ici
    if wire_net:
        collective_s += wire_net / (target.net_gbps * 1e9)
    feas_kv = not (plan.decode_kv == "heads" and cfg.n_kv_heads
                   and tp > 1 and cfg.n_kv_heads % tp != 0)
    if sc.kind == "train":
        ok_batch = B % (dp * plan.microbatch) == 0
    else:
        ok_batch = (B % dp == 0) if B >= dp else (dp == 1)
    feasible = (hbm_need <= target.hbm_bytes * 0.9) and feas_kv and ok_batch \
        and cfg.n_layers % plan.pipeline_stages == 0
    step = max(compute_s, memory_s, collective_s)
    return PlanScore(compute_s=compute_s, memory_s=memory_s,
                     collective_s=collective_s, bubble_frac=bubble,
                     hbm_gb=hbm_need / 1e9, feasible=feasible, step_s=step)


def _cache_bytes(cfg: ModelConfig, sc: ShapeConfig) -> float:
    B, S = sc.global_batch, sc.seq_len
    L = cfg.n_layers
    if cfg.family == "ssm":
        return B * L * (cfg.d_inner * cfg.ssm_state * 4.0
                        + cfg.d_inner * (cfg.ssm_conv - 1) * 2.0)
    if cfg.family == "hybrid":
        W = min(cfg.window or S, S)
        return B * L * (2.0 * W * cfg.n_kv_heads * cfg.head_dim * 2.0
                        + cfg.d_inner * cfg.ssm_state * 4.0)
    if cfg.use_mla:
        return B * L * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0
    return 2.0 * B * L * S * cfg.n_kv_heads * cfg.head_dim * 2.0


# ---------------------------------------------------------------------------
# search: exhaustive ground truth + the paper's GP/PI Bayesian engine
# ---------------------------------------------------------------------------
def plan_space(chips: int = 256, train: bool = True) -> List[ShardPlan]:
    plans = []
    factorizations = [(d, chips // d) for d in (1, 2, 4, 8, 16, 32, 64, 128,
                                                256) if d <= chips]
    for data, rest in factorizations:
        for pp in (1, 2, 4, 8):
            if rest % pp:
                continue
            model = rest // pp
            if model < 1 or model > 256:
                continue
            for mb in ((1, 2, 4, 8, 16, 32) if train else (1,)):
                for remat in (("none", "dots", "full") if train
                              else ("none",)):
                    for fsdp in ((True, False) if train else (False,)):
                        for dk in (("sequence", "heads")
                                   if not train else ("sequence",)):
                            plans.append(ShardPlan(
                                data=data, model=model, microbatch=mb,
                                remat=remat, fsdp=fsdp, decode_kv=dk,
                                pipeline_stages=pp))
    return plans


def exhaustive_best(cfg: ModelConfig, sc: ShapeConfig, chips: int = 256,
                    pods: int = 1, target: H100Target = DEFAULT_H100
                    ) -> Tuple[ShardPlan, PlanScore, List]:
    best, best_s, scored = None, None, []
    for p in plan_space(chips // pods, train=(sc.kind == "train")):
        s = predict(cfg, sc, p, pods=pods, target=target)
        scored.append((p, s))
        if not s.feasible:
            continue
        if best_s is None or s.step_s < best_s.step_s:
            best, best_s = p, s
    return best, best_s, scored


def _encode(plan: ShardPlan, chips: int) -> np.ndarray:
    return np.array([
        math.log2(max(plan.data, 1)) / math.log2(chips),
        math.log2(max(plan.microbatch, 1)) / 5.0,
        {"none": 0.0, "dots": 0.5, "full": 1.0}[plan.remat],
        1.0 if plan.fsdp else 0.0,
        1.0 if plan.decode_kv == "heads" else 0.0,
        math.log2(max(plan.pipeline_stages, 1)) / 3.0,
    ])


def bo_search(cfg: ModelConfig, sc: ShapeConfig, chips: int = 256,
              pods: int = 1, budget: int = 32, seed: int = 0,
              target: H100Target = DEFAULT_H100, device="cuda"):
    """GP + probability-of-improvement over the plan space (the paper's
    engine, Sec. IV-C, reused from ``repro_torch.core.optimizer``), the GP
    on ``device`` (the card unless ``device="cpu"``: its covariance is the
    ``gp_cov`` kernel there).  The draws are numpy's, seeded with ``seed``
    as the reference's.  Returns (best plan, best score, #evaluations,
    trace)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    space = plan_space(chips // pods, train=(sc.kind == "train"))
    Z = np.stack([_encode(p, chips) for p in space])
    Zq = torch.as_tensor(Z, dtype=torch.float32, device=dev)

    def ev(p):
        s = predict(cfg, sc, p, pods=pods, target=target)
        return (s.step_s if s.feasible else s.step_s * 100.0), s

    idx = list(rng.choice(len(space), size=min(8, len(space)),
                          replace=False))
    X = [Z[i] for i in idx]
    Y = []
    trace = []
    for i in idx:
        y, _ = ev(space[i])
        Y.append(math.log(y))
        trace.append((len(trace), min(Y)))
    seen = set(idx)
    for it in range(budget - len(idx)):
        mu, sg = gp_posterior(
            torch.as_tensor(np.stack(X), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(Y), dtype=torch.float32, device=dev),
            Zq)
        pi = prob_improvement(mu, sg, min(Y)).cpu().numpy()
        pi[list(seen)] = -1.0
        j = int(np.argmax(pi))
        seen.add(j)
        y, _ = ev(space[j])
        X.append(Z[j])
        Y.append(math.log(y))
        trace.append((len(trace), min(Y)))
    ib = int(np.argmin(Y))
    best_plan = None
    for j in seen:
        if np.allclose(Z[j], X[ib]):
            best_plan = space[j]
            break
    score = predict(cfg, sc, best_plan, pods=pods, target=target)
    return best_plan, score, len(Y), trace


def advise(cfg: ModelConfig, sc: ShapeConfig, chips: int = 256,
           pods: int = 1, target: H100Target = DEFAULT_H100) -> Dict:
    plan, score, scored = exhaustive_best(cfg, sc, chips, pods, target)
    return {"plan": dataclasses.asdict(plan) if plan else None,
            "score": score.to_dict() if score else None,
            "n_feasible": sum(1 for _, s in scored if s.feasible),
            "n_total": len(scored)}
