"""Workload suites used by the paper's experiments (graph builders only).

* res[2-5]  — the ``res{2,3,4,5}b_branch2b`` 3x3 convolutions of ResNet-50
  (paper Fig. 7, batch 1).
* att[1-4]  — four matrix-multiply shapes from BERT-large (seq 512, hidden
  1024, heads 16, FFN 4096): QKV projection, QK^T scores, scores x V, FFN.
* transformer_block — Fig. 4a: 2 heads = 5 matmuls with the 0->2, 1->3,
  2->4, 3->4 dependency structure, pipelineable across chiplets.
* tt_chain  — Fig. 10: tensor-train contraction chain C23 -> C33 -> C43 -> C52.

The same builders as ``repro.core.presets``; the model-derived
``workload_library`` and the tech presets are not part of the port yet.
"""

from __future__ import annotations

from typing import Dict

from .workload import Edge, WorkloadGraph, contraction, conv2d, matmul


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
