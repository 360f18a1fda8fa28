"""AdamW with the reference's schedules and global-norm clipping
(``repro/optim/adamw.py``), in place over a parameter list.

Parameters are an ``nn.Module`` (its ``named_parameters()``) or a dict of
tensors; moments and gradients are dicts keyed by the same names.  The
moments are stored in ``moment_dtype`` (bfloat16 by default, as the
reference), and the update runs the reference's float32 arithmetic:

    g' = g * min(1, clip_norm / max(|g|, 1e-9))
    m = b1 m + (1 - b1) g',  v = b2 v + (1 - b2) g' g'
    p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with ``torch._foreach_*`` over chunks of the parameter list (each chunk's
float32 temporaries bounded by ``CHUNK_ELEMENTS``), in place under
``no_grad``: the parameters, and the moments, are updated where they lie.
The learning rate and the bias corrections are float32 values computed on
the host from the step count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

# elements of one chunk of the update (its float32 temporaries: a few of
# 4 bytes each of this many elements)
CHUNK_ELEMENTS = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"
    schedule: str = "cosine"        # constant | linear | cosine
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule_lr(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (warmup, then the schedule's decay),
    in float32 arithmetic as the reference computes it."""
    f = np.float32
    step = f(int(step))
    warm = min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    span = f(max(cfg.total_steps - cfg.warmup_steps, 1))
    if cfg.schedule == "constant":
        decay = f(1.0)
    elif cfg.schedule == "linear":
        decay = max(f(1.0) - (step - f(cfg.warmup_steps)) / span, f(0.0))
    else:
        t = np.clip((step - f(cfg.warmup_steps)) / span, f(0.0), f(1.0))
        decay = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t, dtype=f))
    return float(f(cfg.lr) * f(warm) * f(decay))


def named(tree) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) pairs of a module's parameters or of a dict of
    tensors (nested dicts joined with '.')."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [(f"{k}.{n}", t) for n, t in named(v)]
        else:
            out.append((k, v))
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a 0-dim
    float32 tensor on the leaves' device); ``tree`` as ``named`` takes it,
    or a list of tensors."""
    leaves = tree if isinstance(tree, list) else [t for _, t in named(tree)]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for t in leaves:
        total = total + torch.sum(torch.square(t.float()))
    return torch.sqrt(total)


def adamw_init(cfg: AdamWConfig, params) -> Dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and the
    step count (an int32 0-dim tensor)."""
    mdt = getattr(torch, cfg.moment_dtype)
    ps = named(params)
    dev = ps[0][1].device
    return {"mu": {n: torch.zeros_like(p, dtype=mdt) for n, p in ps},
            "nu": {n: torch.zeros_like(p, dtype=mdt) for n, p in ps},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(rows):
    chunk, size = [], 0
    for row in rows:
        if chunk and size + row[0].numel() > CHUNK_ELEMENTS:
            yield chunk
            chunk, size = [], 0
        chunk.append(row)
        size += row[0].numel()
    if chunk:
        yield chunk


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step, IN PLACE on ``params`` and ``opt_state``; returns
    (params, opt_state, {"grad_norm", "lr"}) with the raw gradient norm."""
    ps = named(params)
    gs = dict(named(grads))
    step = int(opt_state["step"]) + 1
    gn = global_norm([gs[n] for n, _ in ps])
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else None)
    lr = schedule_lr(cfg, step)
    f = np.float32
    b1c = float(f(1.0) - f(cfg.b1) ** f(step))
    b2c = float(f(1.0) - f(cfg.b2) ** f(step))
    mu, nu = opt_state["mu"], opt_state["nu"]
    rows = [(p, gs[n], mu[n], nu[n]) for n, p in ps]
    for chunk in _chunks(rows):
        p32 = [r[0] for r in chunk]
        g = [r[1].float() for r in chunk]
        if scale is not None:
            g = torch._foreach_mul(g, scale)
        m = torch._foreach_mul([r[2].float() for r in chunk], cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        v = torch._foreach_mul([r[3].float() for r in chunk], cfg.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1 - cfg.b2), g))
        del g
        den = torch._foreach_sqrt(torch._foreach_div(v, b2c))
        torch._foreach_add_(den, cfg.eps)
        dp = torch._foreach_div(torch._foreach_div(m, b1c), den)
        del den
        torch._foreach_add_(dp, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_sub_(p32, torch._foreach_mul(dp, lr))
        del dp
        for r, m32, v32 in zip(chunk, m, v):
            r[2].copy_(m32)
            r[3].copy_(v32)
    opt_state["step"].fill_(step)
    return params, opt_state, {"grad_norm": gn, "lr": lr}
