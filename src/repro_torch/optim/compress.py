"""Int8 gradient compression with error feedback (the reference's
``repro/optim/compress.py``): each leaf's gradient plus its carried error
is quantized to int8 with one float32 scale, and the residual is carried
to the next step.  Trees are dicts of tensors."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale): scale = max(max |x|, 1e-12) / 127,
    values round(x / scale) clipped to [-127, 127] (halves to even)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Dict) -> Dict:
    return {k: torch.zeros_like(v, dtype=torch.float32)
            for k, v in params.items()}


def compress_grads(grads: Dict, err_state: Dict):
    """Quantize (grad + error) per leaf; returns (int8 tree, scales tree,
    new error state)."""
    qs, ss, es = {}, {}, {}
    for k, g in grads.items():
        x = g.float() + err_state[k]
        qs[k], ss[k] = quantize_int8(x)
        es[k] = x - dequantize_int8(qs[k], ss[k])
    return qs, ss, es


def decompress_grads(qs: Dict, ss: Dict) -> Dict:
    return {k: dequantize_int8(q, ss[k]) for k, q in qs.items()}
