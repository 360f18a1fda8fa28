"""Train-step assembly and the training loop (the reference's
``repro/launch/train.py``), and the command line of the reference's
``examples/train_lm.py``.

    python -m repro_torch.launch.train [--steps 300] [--batch 8] [--seq 256]
        [--ckpt-dir DIR] [--arch ARCH [--reduced]] [--device cuda|cpu]

* ``make_train_state(model, seed, opt_cfg)`` -> ``{"params": module whose
  parameters take gradients, "opt": adamw_init(...)}``;
* ``make_train_step(model, opt_cfg, microbatches)`` -> ``step(state,
  batch) -> (state, metrics)``: ``model.loss`` differentiated by autograd
  (attention and the scan by their kernels' backward passes on the card),
  then ``adamw_update`` IN PLACE on the state, which the step returns.
  With ``microbatches > 1`` the batch is split on its leading axis and the
  float32 gradients are summed over the microbatches, then divided (the
  reference's accumulation);
* ``make_eval_step``, ``LoopResult`` and ``train_loop``.

Without ``--arch`` the CLI trains the example's ~100M-parameter dense
model; with it, a registry config (``--reduced`` for its reduced form),
under the fault-tolerant driver with checkpoints in ``--ckpt-dir``, and
checks that the loss fell.  ``train_state_specs`` gives the state's shapes
and dtypes on meta, for the step analysis (``launch.graph_analysis``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, get_reduced
from ..data.pipeline import DataConfig, SyntheticLM
from ..models.config import ModelConfig
from ..models.model import Model, build_model
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..parallel import ctx
from ..runtime.driver import FaultTolerantTrainer
from .specs import params_specs


def make_train_state(model: Model, seed: int, opt_cfg: AdamWConfig) -> Dict:
    params = model.init(seed)
    params.requires_grad_(True)
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def train_state_specs(model: Model, opt_cfg: AdamWConfig) -> Dict:
    """The train state of ``make_train_state`` as specs on meta (shapes and
    dtypes, no storage, no init draws): the parameter module taking
    gradients and ``adamw_init``'s moments and step count."""
    params = params_specs(model.cfg)
    params.requires_grad_(True)
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def _split(batch: Dict, n: int):
    """``batch`` cut into ``n`` microbatches along the leading axis (a
    batch-sharded DTensor on each rank's own rows: ``ctx.row_block``)."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch leaf {k} of {v.shape[0]} rows does not "
                             f"split into {n} microbatches")
    return [{k: ctx.row_block(v, i, n) for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """(state, batch) -> (state, metrics); updates the state in place."""
    return _train_step(model, opt_cfg, microbatches)


def _train_step(model: Model, opt_cfg: AdamWConfig, microbatches: int,
                first: Optional[int] = None) -> Callable:
    """``make_train_step``'s step; with ``first``, the accumulation loop
    runs the first ``first`` of the ``microbatches`` only (then divides by
    ``microbatches`` as the whole step does): not a training step, but the
    trips of one that the dry run traces to count the whole
    (``launch.dryrun``)."""

    def step(state, batch):
        params = state["params"]
        for p in params.parameters():
            p.grad = None
        if microbatches <= 1:
            loss, parts = model.loss(params, batch)
            loss.backward()
        else:
            loss = aux = 0.0
            for mb in _split(batch, microbatches)[:first]:
                l, pr = model.loss(params, mb)
                l.backward()
                loss = loss + l.detach()
                aux = aux + pr["aux"].detach()
            with torch.no_grad():
                for p in params.parameters():
                    if p.grad is not None:
                        p.grad.div_(microbatches)
            loss = loss / microbatches
            parts = {"xent": loss, "aux": aux / microbatches}
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.named_parameters()}
        _, _, om = adamw_update(opt_cfg, grads, state["opt"], params)
        for p in params.parameters():
            p.grad = None
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return state, metrics

    return step


def make_eval_step(model: Model) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            loss, parts = model.loss(params, batch)
        return {"loss": loss, **parts}
    return step


@dataclasses.dataclass
class LoopResult:
    losses: list
    steps: int
    wall_s: float


def train_loop(model: Model, state, batches, train_step,
               log_every: int = 20,
               on_step: Optional[Callable] = None) -> tuple:
    """Simple driver (``runtime.driver.FaultTolerantTrainer`` is the
    fault-tolerant one); returns (LoopResult, state)."""
    losses = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step is not None:
            on_step(i, state, metrics)
        if log_every and i % log_every == 0:
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
    return LoopResult(losses=losses, steps=len(losses),
                      wall_s=time.time() - t0), state


def model_100m() -> ModelConfig:
    """The reference example's ~100M-parameter dense model."""
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=8, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=3072, vocab=32000,
        remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/train_lm_ckpt_torch")
    ap.add_argument("--arch", default=None,
                    help="a registry config (default: the example's 100M "
                         "dense model)")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch is None:
        cfg = model_100m()
    else:
        cfg = (get_reduced if args.reduced else get_config)(args.arch)
    model = build_model(cfg, args.device)
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.0f}M params on "
          f"{model.device}")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    state = make_train_state(model, args.seed, opt_cfg)
    step = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    trainer = FaultTolerantTrainer(step, CheckpointManager(args.ckpt_dir),
                                   ckpt_every=100)
    report, state = trainer.run(state, data.batch_at, num_steps=args.steps)
    print(f"\ntrained steps {report.start_step}..{report.end_step}: "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"({report.wall_s:.0f}s, restarts={report.restarts}, "
          f"stragglers={len(report.straggler_steps)})")
    if not report.losses[-1] < report.losses[0]:
        raise SystemExit("loss did not decrease")
    return report


if __name__ == "__main__":
    main()
