"""The port's LM serving slice (``repro_torch.models``, ``launch.serve``)
against the JAX reference ``repro.models`` at the reduced Hymba config
(2 layers, d 64, 4/2 heads, window 32, 8 meta tokens, ssm_state 8), with
the reference's weights carried across by ``convert.lm_params_from_reference``
and inputs drawn with numpy.

Tolerances: float32 atol/rtol 1e-4 — both packages run full float32, so
only the order of sums differs (XLA vs ATen products, the reference's
associative scan vs the port's sequential one; observed ~4e-6 on the
logits).  bfloat16 atol/rtol 0.1 on logits of magnitude up to ~4 — the two
frameworks round bf16 intermediates at different places (observed ~0.09).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as jLy
from repro.models import transformer as jTr
from repro.models.model import build_model as jax_build
from repro_torch import configs
from repro_torch.convert import (load_reference_params,
                                 lm_params_from_reference)
from repro_torch.launch import serve
from repro_torch.models import layers as Ly
from repro_torch.models import transformer as Tr
from repro_torch.models.config import SHAPES
from repro_torch.models.model import build_model

ARCH = "hymba-1.5b"
B, S, N_NEW = 2, 40, 4          # prompt 40 + 8 meta > window 32: it binds
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.1, rtol=0.1)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().cpu().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


class Pair:
    """One config in both packages, with the reference's weights."""

    def __init__(self, dtype):
        self.jcfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype)
        self.cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype)
        self.jm = jax_build(self.jcfg)
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        self.m = build_model(self.cfg, device="cpu")
        self.p = lm_params_from_reference(self.jp, self.cfg, device="cpu")
        self.tokens = np.random.default_rng(0).integers(
            0, self.cfg.vocab, (B, S)).astype(np.int32)
        self._runs = None

    def runs(self):
        """Forward, prefill and N_NEW - 1 greedy decode steps in both
        packages (the port fed the reference's tokens), computed once."""
        if self._runs is None:
            jbatch = {"tokens": jnp.asarray(self.tokens)}
            tbatch = {"tokens": torch.as_tensor(self.tokens).long()}
            max_seq = S + self.cfg.meta_tokens + N_NEW + 1
            jl, jc = jax.jit(self.jm.prefill)(self.jp, jbatch,
                                              self.jm.init_cache(B, max_seq))
            tl, tc = self.m.prefill(self.p, tbatch,
                                    self.m.init_cache(B, max_seq))
            steps = [(jl, jc, tl, tc)]
            decode = jax.jit(self.jm.decode_step)
            base = S + self.cfg.meta_tokens
            for i in range(N_NEW - 1):
                tok = np.argmax(_np(jl)[:, -1], -1)[:, None].astype(np.int32)
                jl, jc = decode(self.jp, jnp.asarray(tok), jc, base + i)
                tl, tc = self.m.decode_step(self.p, torch.as_tensor(tok).long(),
                                            tc, base + i)
                steps.append((jl, jc, tl, tc))
            self._runs = dict(
                forward=(jax.jit(self.jm.forward)(self.jp, jbatch)[0],
                         self.m.forward(self.p, tbatch)),
                steps=steps)
        return self._runs


@pytest.fixture(scope="module")
def f32():
    return Pair("float32")


@pytest.fixture(scope="module")
def bf16():
    return Pair("bfloat16")


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["blocks"])


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------- configs
def test_config_registry_matches_reference():
    import repro.configs as jc
    assert configs.ARCH_IDS == jc.ARCH_IDS and configs.ALIASES == jc.ALIASES
    for arch in configs.ARCH_IDS:
        for get, jget in ((configs.get_config, jc.get_config),
                          (configs.get_reduced, jc.get_reduced)):
            a, b = get(arch), jget(arch)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.padded_vocab, a.d_inner, a.param_count(),
                    a.is_attention_free, a.subquadratic) == \
                (b.padded_vocab, b.d_inner, b.param_count(),
                 b.is_attention_free, b.subquadratic)
        assert configs.cells(arch) == jc.cells(arch)
    assert configs.get_config(ARCH).param_count() == 1_641_577_600
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}


# ----------------------------------------------------------------- layers
def test_rmsnorm_and_rope(f32):
    jp = _layer0(f32.jp)
    blk = load_reference_params(Tr.Block(f32.cfg, "hybrid"), jax.tree.map(
        np.asarray, jp))
    x = _x((B, 7, f32.cfg.d_model)) * 3
    _close(Ly.rmsnorm(blk.ln1, torch.as_tensor(x)),
           jLy.rmsnorm(jp["ln1"], jnp.asarray(x)), F32)
    q = _x((B, 7, 4, 16))
    pos = np.random.default_rng(2).integers(0, 5000, (B, 7))
    _close(Ly.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), 1e4),
           jLy.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4), F32)


def test_attention_decode_rolling(f32):
    cfg, jp = f32.cfg, _layer0(f32.jp)
    attn = load_reference_params(Ly.Attention(cfg), jax.tree.map(
        np.asarray, jp["attn"]))
    W, KV, hd = 12, cfg.n_kv_heads, cfg.head_dim
    ck, cv = _x((B, W, KV, hd), 4), _x((B, W, KV, hd), 5)
    kpos = np.where(np.arange(W) < 3, -1, 20 + np.arange(W)).astype(
        np.int32)[None].repeat(B, 0)                   # some slots empty
    x = _x((B, 1, cfg.d_model), 6)
    for position, window in ((32, 16), (33, 8)):
        wcfg = dataclasses.replace(cfg, window=window)
        j_out, j_c = jLy.attention_decode_rolling(
            jp["attn"], f32.jcfg, jnp.asarray(x), position,
            (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kpos)), window)
        t_out, t_c = Ly.attention_decode_rolling(
            attn, wcfg, torch.as_tensor(x), position,
            tuple(map(torch.as_tensor, (ck, cv, kpos))))
        _close(t_out, j_out, F32)
        for a, b in zip(t_c, j_c):
            _close(a, b, F32)


def test_mamba_full_sequence_and_one_step(f32):
    cfg, jp = f32.cfg, _layer0(f32.jp)
    mam = load_reference_params(Ly.Mamba(cfg), jax.tree.map(
        np.asarray, jp["mamba"]))
    x = _x((B, 9, cfg.d_model), 7)
    j_y, (j_conv, j_h) = jLy.mamba_apply(jp["mamba"], f32.jcfg,
                                         jnp.asarray(x))
    t_y, (t_conv, t_h) = Ly.mamba_apply(mam, cfg, torch.as_tensor(x))
    for a, b in ((t_y, j_y), (t_conv, j_conv), (t_h, j_h)):
        _close(a, b, F32)
    x1 = _x((B, 1, cfg.d_model), 8)
    j_y, j_state = jLy.mamba_apply(jp["mamba"], f32.jcfg, jnp.asarray(x1),
                                   state=(j_conv, j_h))
    t_y, t_state = Ly.mamba_apply(mam, cfg, torch.as_tensor(x1),
                                  state=(t_conv, t_h))
    _close(t_y, j_y, F32)
    for a, b in zip(t_state, j_state):
        _close(a, b, F32)


def test_hybrid_block_prefill(f32):
    cfg, jp = f32.cfg, _layer0(f32.jp)
    blk = load_reference_params(Tr.Block(cfg, "hybrid"), jax.tree.map(
        np.asarray, jp))
    St = 45                                    # past the window of 32
    x = _x((B, St, cfg.d_model), 9)
    pos = np.broadcast_to(np.arange(St)[None], (B, St)).copy()
    j_x, j_c, _ = jTr.block_apply(jp, f32.jcfg, "hybrid", jnp.asarray(x),
                                  jnp.asarray(pos))
    t_x, t_c, _ = Tr.block_apply(blk, cfg, torch.as_tensor(x),
                                 torch.as_tensor(pos))
    _close(t_x, j_x, F32)
    for a, b in zip(jax.tree.leaves(j_c), [*t_c[0], *t_c[1]]):
        _close(b, a, F32)


# ------------------------------------------------------------------ model
def test_forward_logits(f32):
    j, t = f32.runs()["forward"]
    assert tuple(t.shape) == (B, S, f32.cfg.padded_vocab)
    _close(t, j, F32)


def test_prefill_and_decode_logits_and_every_cache_leaf(f32):
    for jl, jc, tl, tc in f32.runs()["steps"]:
        _close(tl, jl, F32)
        leaves = [*tc[0], *tc[1]]
        assert len(leaves) == len(jax.tree.leaves(jc))
        for a, b in zip(leaves, jax.tree.leaves(jc)):
            assert tuple(a.shape) == b.shape
            _close(a, b, F32)


def test_bf16_forward_prefill_and_decode(bf16):
    r = bf16.runs()
    _close(r["forward"][1], r["forward"][0], BF16)
    for jl, jc, tl, tc in r["steps"]:
        assert tl.dtype == torch.bfloat16
        _close(tl, jl, BF16)
        for a, b in zip([*tc[0], *tc[1]], jax.tree.leaves(jc)):
            _close(a, b, BF16)


def test_generate_matches_the_reference_serve_loop(f32):
    """examples/serve.py's greedy loop on the JAX side, ``generate`` on the
    port's: the same weights and prompt give the same tokens."""
    n_new = 8
    jm, jp, cfg = f32.jm, f32.jp, f32.jcfg
    cache = jm.init_cache(B, S + cfg.meta_tokens + n_new + 1)
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
        f32.tokens)}, cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out = [tok]
    decode = jax.jit(jm.decode_step)
    for i in range(n_new - 1):
        logits, cache = decode(jp, tok, cache, S + cfg.meta_tokens + i)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(tok)
    want = np.asarray(jnp.concatenate(out, axis=1))
    r = serve.generate(f32.m, f32.p, f32.tokens, n_new)
    np.testing.assert_array_equal(r.tokens.numpy(), want)
    _close(r.logits, logits, F32)
    assert r.prefill_s > 0 and r.decode_s > 0


def test_init_draws_the_reference_distributions():
    cfg = configs.get_reduced(ARCH)
    p = build_model(cfg, device="cpu").init(0)
    q = build_model(cfg, device="cpu").init(0)
    for (name, a), b in zip(p.named_parameters(), q.parameters()):
        assert torch.equal(a, b), name            # seeded
    blk = p.blocks[0]
    assert torch.equal(blk.mamba.A_log[0], torch.log(torch.arange(
        1, cfg.ssm_state + 1, dtype=torch.float32)))
    assert bool((blk.ln1.scale == 1).all() and (blk.mamba.D == 1).all())
    w = blk.attn.wq.w
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert sum(x.numel() for x in p.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(
            jax_build(jax_reduced(ARCH)).init(jax.random.PRNGKey(0))))


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt", "12", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=hymba-reduced device=cpu" in out and "tok/s" in out


# ---------------------------------------------------------- entry points
def test_entry_points_default_to_the_card(monkeypatch, f32):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_reference(f32.jp, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced", "--tokens", "2"])
