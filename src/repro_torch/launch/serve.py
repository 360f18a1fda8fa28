"""Serve an LM of the port: batched greedy prefill + decode with the
family's cache, the loop of the reference's ``examples/serve.py``.

    python -m repro_torch.launch.serve --arch internlm2-1.8b --batch 4 \\
        --prompt 1024 --tokens 32 [--reduced] [--device cpu] [--seed 0]

Any architecture of ``repro_torch.configs`` serves.  Weights are drawn
from ``--seed`` (no checkpoint is loaded); the prompt, and the inputs the
family's stub frontends would give, are drawn from ``--seed + 1``:
``audio_embeds`` (B, enc_positions, d) for ``encdec``, and for ``vlm``
``patch_embeds`` (B, 4, d) with (B, S, 3) ``positions`` (equal t / h / w
streams).  ``--reduced`` serves the architecture's reduced config.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config, get_reduced
from ..models.model import Model, build_model

VLM_PATCHES = 4      # patch embeddings the CLI splices into a vlm prompt


@dataclasses.dataclass(frozen=True)
class Generation:
    tokens: torch.Tensor      # (B, n_new) greedy tokens
    logits: torch.Tensor      # (B, 1, padded_vocab) of the last step
    prefill_s: float          # prompt processing, synchronized
    decode_s: float           # the n_new - 1 decode steps, synchronized


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, params, tokens, n_new: int,
             **inputs) -> Generation:
    """Greedy decoding of ``n_new`` tokens after the prompt ``tokens``
    (B, S): one prefill, then ``n_new - 1`` decode steps at absolute
    positions ``S + meta_tokens + i``, as the reference's serve loop.
    ``inputs`` go into the prefill batch beside the tokens:
    ``audio_embeds`` for ``encdec``; ``patch_embeds`` and ``positions``
    for ``vlm`` (decode positions are broadcast to the 3 streams)."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    dev, cfg = model.device, model.cfg
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    batch = {"tokens": tokens} | {k: torch.as_tensor(v, device=dev)
                                  for k, v in inputs.items()}
    cache = model.init_cache(B, S + cfg.meta_tokens + n_new + 1)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    base = S + cfg.meta_tokens
    for i in range(n_new - 1):
        logits, cache = model.decode_step(params, tok, cache, base + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), logits, t1 - t0, t2 - t1)


def stub_inputs(cfg, batch: int, prompt: int,
                gen: torch.Generator) -> dict:
    """The inputs of the family's stub frontends, drawn from ``gen`` (on
    the CPU): ``audio_embeds`` for ``encdec``, ``patch_embeds`` and
    ``positions`` for ``vlm``, nothing for the others."""
    if cfg.family == "encdec":
        return {"audio_embeds": torch.randn(
            batch, cfg.enc_positions, cfg.d_model, generator=gen)}
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(batch, VLM_PATCHES, cfg.d_model,
                                            generator=gen),
                "positions": torch.arange(prompt)[None, :, None].expand(
                    batch, prompt, 3)}
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                           generator=gen)
    inputs = stub_inputs(cfg, args.batch, args.prompt, gen)
    r = generate(model, params, prompt, args.tokens, **inputs)
    if not bool(torch.isfinite(r.logits).all()):
        raise RuntimeError("non-finite logits")
    B, n = args.batch, args.tokens
    step_ms = r.decode_s / max(n - 1, 1) * 1e3
    print(f"arch={cfg.name} device={model.device} batch={B} "
          f"prompt={args.prompt} generated={n}")
    print(f"first sequence: {r.tokens[0].tolist()}")
    print(f"prefill {r.prefill_s:.3f} s; decode {step_ms:.2f} ms/step; "
          f"{B * n / (r.prefill_s + r.decode_s):.1f} tok/s")


if __name__ == "__main__":
    main()
