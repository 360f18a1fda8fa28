"""Model assembly of the port's LM substrate: ``build_model(cfg)`` ->
init / forward / init_cache / prefill / decode_step / loss for every
family, the surface of the reference's ``repro/models/model.py``.

As in the reference the functions take the parameters and caches
explicitly: ``params`` is the module that ``init`` returns (``DecoderLM``
or ``EncDecLM``; ``convert.lm_params_from_reference`` fills one from
reference weights), and a cache is the reference's nested tuple (a dict
for ``encdec``) of tensors with a leading layer axis:

    dense, vlm, moe   (k, v) each (L, B, max_seq, KV, hd); MLA's latent
                      (L, B, max_seq, kv_lora_rank + qk_rope_dim)
    ssm               (conv (L, B, ssm_conv - 1, d_inner), h (L, B,
                      d_inner, ssm_state) float32)
    hybrid            ((k, v, kpos) rolling over the window, (conv, h))
    encdec            {"self": (k, v), "enc": (B, enc_positions, d)}

``prefill`` and ``decode_step`` write into the cache they are given and
return the cache to use next: a full KV cache (or MLA's latent, or
Hymba's window after a prefill) is updated in place and returned, with
no copy of it a step; SSM states and Hymba's decode window come back as
new tensors.  A caller that needs the old cache again keeps a copy
(``transformer.tree_map(torch.clone, cache)``).  Attention runs the
flash-attention kernel once per layer (decode too, over the full cache
with ``kv_valid_len``; Hymba's rolling decode excepted), the Mamba scan
once per layer.

``loss(params, batch) -> (total, {"xent", "aux"})`` is the training
objective (the reference's ``_xent``, plus 0.01 x the MoE load-balancing
loss for the decoder families): a forward that autograd records, through
the layer stack's checkpointed groups, with labels defaulting to the
shifted tokens and an optional ``loss_mask``.  ``forward``, ``prefill``
and ``decode_step`` run under ``no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from .. import runtime
from ..parallel import ctx
from . import layers as Ly
from . import transformer as Tr
from .config import ModelConfig

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


class _LM(nn.Module):
    """``embed`` (padded_vocab, d), ``final_norm`` and ``lm_head`` (unless
    tied), named as the reference's pytree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.embed = Ly.new_param((cfg.padded_vocab, d), device)
        self.final_norm = Ly.RMSNorm(d, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Ly.Dense(d, cfg.padded_vocab, device=device))

    def reset(self, gen: torch.Generator):
        """The reference's init distributions, drawn from ``gen``."""
        Ly.normal_fill_(self.embed, gen, 0.02)
        Ly.reset_children(self, gen)


class DecoderLM(_LM):
    """A decoder-only LM: ``blocks`` (one module per layer, of the
    family's kind) and ``meta`` (meta_tokens, d) where the config has
    meta tokens."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        kind = "dense" if cfg.family == "vlm" else cfg.family
        self.blocks = nn.ModuleList(Tr.Block(cfg, kind, device)
                                    for _ in range(cfg.n_layers))
        self.meta = (Ly.new_param((cfg.meta_tokens, cfg.d_model), device)
                     if cfg.meta_tokens else None)

    def reset(self, gen: torch.Generator):
        super().reset(gen)
        if self.meta is not None:
            Ly.normal_fill_(self.meta, gen, 0.02)


class EncDecLM(_LM):
    """An encoder-decoder LM (Whisper): ``encoder`` (enc_layers ``enc``
    blocks) and ``decoder`` (n_layers ``dec`` blocks)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.encoder = nn.ModuleList(Tr.Block(cfg, "enc", device)
                                     for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(Tr.Block(cfg, "dec", device)
                                     for _ in range(cfg.n_layers))


def lm_module(cfg: ModelConfig, device=None) -> _LM:
    """The (uninitialized) parameter module of ``cfg``'s family."""
    return (EncDecLM if cfg.family == "encdec" else DecoderLM)(cfg, device)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable            # (seed) -> params
    forward: Callable         # (params, batch) -> logits (B, S, V)
    init_cache: Callable      # (batch, max_seq) -> cache
    prefill: Callable         # (params, batch, cache) -> (logits, cache)
    decode_step: Callable     # (params, tokens, cache, index) -> ...
    loss: Callable            # (params, batch) -> (loss, metrics)


def _logits(p: _LM, cfg: ModelConfig, x):
    h = Ly.rmsnorm(p.final_norm, x)
    if cfg.tie_embeddings:
        out = h @ p.embed.t().to(h.dtype)
    else:
        out = Ly.dense(p.lm_head, h)
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(cfg.padded_vocab, device=out.device)
        out = out.masked_fill(ids >= cfg.vocab, -1e9)
    return out


def _positions(B: int, S: int, cfg: ModelConfig, device) -> torch.Tensor:
    """Positions 0..S-1 for every row: (B, S), or (B, S, 3) (equal
    streams) with M-RoPE."""
    pos = torch.arange(S, device=device)[None].expand(B, S)
    return pos[..., None].expand(B, S, 3) if cfg.mrope_sections else pos


def _decode_positions(B: int, index: int, cfg: ModelConfig, device):
    """The decoded token's position ``index`` for every row (and every
    M-RoPE stream)."""
    shape = (B, 1, 3) if cfg.mrope_sections else (B, 1)
    return torch.full(shape, int(index), dtype=torch.long, device=device)


def _embed(p: _LM, tokens, dt, dev) -> torch.Tensor:
    return ctx.lookup(p.embed, torch.as_tensor(tokens, device=dev), dt)


def _xent(logits, labels, mask=None):
    """Mean next-token cross-entropy in float32 (over ``mask`` where given,
    its sum floored at 1)."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - ctx.take_last(lf, labels.long())
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _loss_of(logits, aux, batch, dev, aux_weight: float):
    """(total, {"xent", "aux"}): labels from the batch or the tokens
    shifted left (0 at the end), ``loss_mask`` where given."""
    labels = batch.get("labels")
    if labels is None:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    labels = torch.as_tensor(labels, device=dev)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).float()
    # the vocabulary whole on each rank for the loss (sharded layouts)
    xent = _xent(ctx.shard(logits, ("batch", "seq", None)), labels, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


def _kv_cache(cfg: ModelConfig, L: int, B: int, max_seq: int, dt, dev):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return tuple(torch.zeros((L, B, max_seq, KV, hd), dtype=dt, device=dev)
                 for _ in range(2))


def _ssm_cache(cfg: ModelConfig, B: int, dt, dev):
    L = cfg.n_layers
    return (torch.zeros((L, B, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt,
                        device=dev),
            torch.zeros((L, B, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# decoder-only families (dense / moe / ssm / hybrid / vlm)
# ---------------------------------------------------------------------------
def _build_decoder(cfg: ModelConfig, dev: torch.device) -> Model:
    dt = getattr(torch, cfg.dtype)

    def init(seed: int) -> DecoderLM:
        p = DecoderLM(cfg, dev)
        p.reset(runtime.generator(seed, dev))
        return p

    def embed_inputs(p: DecoderLM, batch):
        """Token embeddings; for ``vlm`` the batch's ``patch_embeds`` (B,
        P, d) replace the first P positions (the vision frontend is a
        stub); the meta tokens go in front."""
        x = _embed(p, batch["tokens"], dt, dev)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = torch.as_tensor(batch["patch_embeds"], device=dev).to(dt)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        if cfg.meta_tokens:
            meta = p.meta.to(dt)[None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return ctx.shard(x, ("batch", "seq", None))

    def positions(batch, B: int, St: int):
        if "positions" in batch:
            return torch.as_tensor(batch["positions"], device=dev)
        return _positions(B, St, cfg, dev)

    def logits_and_aux(p: DecoderLM, batch):
        x = embed_inputs(p, batch)
        B, St = x.shape[:2]
        x, _, aux = Tr.stack_apply(p.blocks, cfg, x, positions(batch, B, St))
        return _logits(p, cfg, x[:, cfg.meta_tokens:]), aux

    @torch.no_grad()
    def forward(p: DecoderLM, batch) -> torch.Tensor:
        """Full-sequence logits (B, S, padded_vocab) of ``batch["tokens"]``
        (the meta-token positions dropped); ``vlm`` takes
        ``patch_embeds`` and (B, S, 3) ``positions`` from the batch."""
        return logits_and_aux(p, batch)[0]

    def loss(p: DecoderLM, batch):
        """xent + 0.01 x the MoE aux loss, differentiable."""
        logits, aux = logits_and_aux(p, batch)
        return _loss_of(logits, aux, batch, dev, 0.01)

    def init_cache(batch_size: int, max_seq: int):
        """The family's empty cache (see the module docstring): hybrid
        windows hold W = min(window, max_seq) + meta_tokens entries, kpos
        -1 (empty)."""
        L, B = cfg.n_layers, batch_size
        if cfg.family == "ssm":
            return _ssm_cache(cfg, B, dt, dev)
        if cfg.family == "hybrid":
            KV, hd = cfg.n_kv_heads, cfg.head_dim
            W = min(cfg.window or max_seq, max_seq) + cfg.meta_tokens
            attn = (torch.zeros((L, B, W, KV, hd), dtype=dt, device=dev),
                    torch.zeros((L, B, W, KV, hd), dtype=dt, device=dev),
                    torch.full((L, B, W), -1, dtype=torch.int32, device=dev))
            return (attn, _ssm_cache(cfg, B, dt, dev))
        if cfg.use_mla:
            return torch.zeros(
                (L, B, max_seq, cfg.kv_lora_rank + cfg.qk_rope_dim),
                dtype=dt, device=dev)
        return _kv_cache(cfg, L, B, max_seq, dt, dev)

    def hybrid_cache(raw, cache, St: int):
        """The rolling cache after a hybrid prefill, written into
        ``cache``'s window in place: the last W keys and values of the
        sequence, with their positions, and the SSM states."""
        (k_full, v_full), m_state = raw
        ck, cv, kpos = cache[0]
        W = ck.shape[2]
        take = min(W, St)
        ck[:, :, W - take:] = k_full[:, :, St - take:].to(dt)
        cv[:, :, W - take:] = v_full[:, :, St - take:].to(dt)
        kpos[:, :, W - take:] = torch.arange(St - take, St, dtype=kpos.dtype,
                                             device=dev)
        return ((ck, cv, kpos), m_state)

    @torch.no_grad()
    def prefill(p: DecoderLM, batch, cache):
        """Process the prompt; return the last token's logits (B, 1,
        padded_vocab) and the filled cache: keys and values (or MLA's
        latent) written at positions [0, S), SSM states after the prompt,
        or the hybrid rolling window."""
        x = embed_inputs(p, batch)
        B, St = x.shape[:2]
        pos = positions(batch, B, St)
        if cfg.family == "ssm":
            x, new_cache, _ = Tr.stack_apply(p.blocks, cfg, x, pos,
                                             caches=cache)
        elif cfg.family == "hybrid":
            x, raw, _ = Tr.stack_apply(p.blocks, cfg, x, pos,
                                       collect_caches=True)
            new_cache = hybrid_cache(raw, cache, St)
        else:
            x, new_cache, _ = Tr.stack_apply(p.blocks, cfg, x, pos,
                                             caches=cache, cache_index=0)
        x = x[:, cfg.meta_tokens:]
        return _logits(p, cfg, x[:, -1:]), new_cache

    @torch.no_grad()
    def decode_step(p: DecoderLM, tokens, cache, index: int):
        """One decode step.  tokens: (B, 1); index: the token's absolute
        position (prompt + meta tokens + tokens decoded so far), on every
        M-RoPE stream for ``vlm``."""
        x = _embed(p, tokens, dt, dev)
        pos = _decode_positions(x.shape[0], index, cfg, dev)
        x, new_cache, _ = Tr.stack_apply(
            p.blocks, cfg, x, pos, caches=cache,
            cache_index=None if cfg.family == "ssm" else int(index))
        return _logits(p, cfg, x), new_cache

    return Model(cfg, dev, init, forward, ctx.cache_layout(cfg, init_cache),
                 prefill, decode_step, loss)


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------
def _build_encdec(cfg: ModelConfig, dev: torch.device) -> Model:
    dt = getattr(torch, cfg.dtype)

    def init(seed: int) -> EncDecLM:
        p = EncDecLM(cfg, dev)
        p.reset(runtime.generator(seed, dev))
        return p

    def encode(p: EncDecLM, batch):
        """``batch["audio_embeds"]`` (B, frames, d), the post-conv frame
        embeddings (the conv frontend is a stub), through the encoder."""
        x = torch.as_tensor(batch["audio_embeds"], device=dev).to(dt)
        B, S = x.shape[:2]
        x, _, _ = Tr.stack_apply(p.encoder, cfg, x, _positions(B, S, cfg, dev))
        return x

    def decode(p: EncDecLM, tokens, enc, pos, caches=None,
               cache_index=None):
        x = _embed(p, tokens, dt, dev)
        x, self_kv, _ = Tr.stack_apply(p.decoder, cfg, x, pos, caches=caches,
                                       cache_index=cache_index, enc_out=enc)
        return x, self_kv

    def logits(p: EncDecLM, batch):
        B, S = batch["tokens"].shape
        x, _ = decode(p, batch["tokens"], encode(p, batch),
                      _positions(B, S, cfg, dev))
        return _logits(p, cfg, x)

    @torch.no_grad()
    def forward(p: EncDecLM, batch) -> torch.Tensor:
        return logits(p, batch)

    def loss(p: EncDecLM, batch):
        """The decoder's xent (aux 0), differentiable."""
        return _loss_of(logits(p, batch), 0.0, batch, dev, 0.0)

    def init_cache(batch_size: int, max_seq: int):
        """{"self": the decoder's (k, v), "enc": the encoder output}."""
        return {"self": _kv_cache(cfg, cfg.n_layers, batch_size, max_seq, dt,
                                  dev),
                "enc": torch.zeros((batch_size, cfg.enc_positions,
                                    cfg.d_model), dtype=dt, device=dev)}

    @torch.no_grad()
    def prefill(p: EncDecLM, batch, cache):
        enc = encode(p, batch)
        B, S = batch["tokens"].shape
        x, self_kv = decode(p, batch["tokens"], enc,
                            _positions(B, S, cfg, dev), cache["self"], 0)
        return _logits(p, cfg, x[:, -1:]), {"self": self_kv, "enc": enc}

    @torch.no_grad()
    def decode_step(p: EncDecLM, tokens, cache, index: int):
        pos = _decode_positions(len(tokens), index, cfg, dev)
        x, self_kv = decode(p, tokens, cache["enc"], pos, cache["self"],
                            int(index))
        return _logits(p, cfg, x), {"self": self_kv, "enc": cache["enc"]}

    return Model(cfg, dev, init, forward, ctx.cache_layout(cfg, init_cache),
                 prefill, decode_step, loss)


def build_model(cfg: ModelConfig, device=runtime.DEFAULT_DEVICE) -> Model:
    """The serving functions of ``cfg`` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``).  ``device="meta"`` gives
    shapes only (``launch.specs``): its ``init_cache`` allocates nothing,
    and nothing of it runs a computation."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name}); "
                         f"known: {PORTED_FAMILIES}")
    dev = (torch.device("meta") if str(device) == "meta"
           else runtime.resolve_device(device))
    if cfg.family == "encdec":
        return _build_encdec(cfg, dev)
    return _build_decoder(cfg, dev)
