"""Every LM family of the port (``repro_torch.models``, ``launch.serve``)
against the JAX reference ``repro.models``, at the reduced config of each
architecture but Hymba (``tests/test_torch_lm.py`` holds that one): dense
(stablelm, qwen2, qwen2.5, internlm2), moe (grok-1 with GQA, deepseek-v2
with MLA and shared experts), ssm (falcon-mamba), encdec (whisper) and
vlm (qwen2-vl with M-RoPE).  The reference's weights are carried across
by ``convert.lm_params_from_reference`` and every input is drawn with
numpy.

Tolerances as in ``tests/test_torch_lm.py``: float32 atol/rtol 1e-4 (both
packages run full float32; only the order of sums differs), bfloat16
atol/rtol 0.1 on logits of magnitude up to ~4 (the frameworks round bf16
intermediates at different places).  The MoE aux loss is a float32 mean
of router probabilities: within 1e-6.
"""

import dataclasses
import functools

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
from repro_torch.models.model import PORTED_FAMILIES, build_model

ARCHS = [a for a in configs.ARCH_IDS if a != "hymba_1_5b"]
B, S, N_NEW = 2, 12, 4
PATCHES = 4
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.1, rtol=0.1)
AUX = dict(atol=1e-6, rtol=0)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().cpu().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _vlm_positions(B: int, S: int) -> np.ndarray:
    """(B, S, 3) M-RoPE positions: a 2 x 2 grid of patches at t = 0, then
    text on equal streams (the patch positions held distinct)."""
    pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).copy()
    pos[:, :PATCHES, 0] = 0
    pos[:, :PATCHES, 1] = [0, 0, 1, 1]
    pos[:, :PATCHES, 2] = [0, 1, 0, 1]
    return pos


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    """The reference's init of ``arch``'s reduced config (float32
    parameters whatever the activation dtype), jitted, drawn once."""
    return jax.jit(jax_build(jax_reduced(arch)).init)(jax.random.PRNGKey(0))


# the reference's layer functions, jitted with the config and the options
# that shape the computation static
J_ATTN = jax.jit(jLy.attention_apply, static_argnums=1, static_argnames=(
    "mask_kind", "window", "cache_index", "use_rope"))
J_MLA = jax.jit(jLy.mla_apply, static_argnums=1,
                static_argnames="cache_index")
J_MOE = jax.jit(jLy.moe_apply, static_argnums=1)
J_STACK = jax.jit(jTr.stack_apply, static_argnums=(1, 2))
J_STACK_INIT = jax.jit(jTr.stack_init, static_argnums=(1, 2, 3))


class Pair:
    """One architecture in both packages, with the reference's weights."""

    def __init__(self, arch: str, dtype: str):
        self.arch = arch
        self.jcfg = dataclasses.replace(jax_reduced(arch), dtype=dtype)
        self.cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
        self.jm = jax_build(self.jcfg)
        self.jp = _reference_params(arch)
        self.m = build_model(self.cfg, device="cpu")
        self.p = lm_params_from_reference(self.jp, self.cfg, device="cpu")
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.inputs = {}
        if self.cfg.family == "encdec":
            self.inputs["audio_embeds"] = rng.standard_normal(
                (B, self.cfg.enc_positions, self.cfg.d_model)).astype(
                np.float32)
        if self.cfg.family == "vlm":
            self.inputs["patch_embeds"] = rng.standard_normal(
                (B, PATCHES, self.cfg.d_model)).astype(np.float32)
            self.inputs["positions"] = _vlm_positions(B, S)
        self._runs = None

    def batches(self):
        j = {"tokens": jnp.asarray(self.tokens)} | {
            k: jnp.asarray(v) for k, v in self.inputs.items()}
        t = {"tokens": torch.as_tensor(self.tokens).long()} | {
            k: torch.as_tensor(v) for k, v in self.inputs.items()}
        return j, t

    def runs(self):
        """Forward, prefill and N_NEW - 1 greedy decode steps in both
        packages (the port fed the reference's tokens), and the
        reference's greedy tokens, computed once.  The port writes its
        cache in place, so each step keeps a copy of the cache after it."""
        if self._runs is None:
            jbatch, tbatch = self.batches()
            max_seq = S + self.cfg.meta_tokens + N_NEW + 1
            jl, jc = jax.jit(self.jm.prefill)(self.jp, jbatch,
                                              self.jm.init_cache(B, max_seq))
            tl, tc = self.m.prefill(self.p, tbatch,
                                    self.m.init_cache(B, max_seq))
            steps = [(jl, jc, tl, Tr.tree_map(torch.clone, tc))]
            decode = jax.jit(self.jm.decode_step)
            base = S + self.cfg.meta_tokens
            greedy = []
            for i in range(N_NEW - 1):
                tok = np.argmax(_np(jl)[:, -1], -1)[:, None].astype(np.int32)
                greedy.append(tok)
                jl, jc = decode(self.jp, jnp.asarray(tok), jc, base + i)
                tl, tc = self.m.decode_step(self.p, torch.as_tensor(tok).long(),
                                            tc, base + i)
                steps.append((jl, jc, tl, Tr.tree_map(torch.clone, tc)))
            greedy.append(np.argmax(_np(jl)[:, -1], -1)[:, None])
            self._runs = dict(
                forward=(jax.jit(self.jm.forward)(self.jp, jbatch)[0],
                         self.m.forward(self.p, tbatch)),
                steps=steps, greedy=np.concatenate(greedy, axis=1))
        return self._runs


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return Pair(request.param, "float32")


@pytest.fixture(scope="module", params=ARCHS)
def bf16(request):
    return Pair(request.param, "bfloat16")


# ------------------------------------------------------------ whole models
def test_forward_logits(f32):
    j, t = f32.runs()["forward"]
    assert tuple(t.shape) == (B, S, f32.cfg.padded_vocab)
    _close(t, j, F32)


def test_prefill_and_decode_logits_and_every_cache_leaf(f32):
    for jl, jc, tl, tc in f32.runs()["steps"]:
        _close(tl, jl, F32)
        leaves, jleaves = Tr.tree_leaves(tc), jax.tree.leaves(jc)
        assert len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            _close(a, b, F32)


def test_bf16_forward_prefill_and_decode(bf16):
    r = bf16.runs()
    _close(r["forward"][1], r["forward"][0], BF16)
    for jl, jc, tl, tc in r["steps"]:
        assert tl.dtype == torch.bfloat16
        _close(tl, jl, BF16)
        for a, b in zip(Tr.tree_leaves(tc), jax.tree.leaves(jc)):
            _close(a, b, BF16)


def test_generate_matches_the_reference_serve_loop(f32):
    """examples/serve.py's greedy loop on the JAX side (``runs``' greedy
    tokens), ``generate`` on the port's, with the family's stub inputs:
    the same weights and prompt give the same tokens."""
    r = serve.generate(f32.m, f32.p, f32.tokens, N_NEW, **f32.inputs)
    np.testing.assert_array_equal(r.tokens.numpy(), f32.runs()["greedy"])
    _close(r.logits, f32.runs()["steps"][-1][0], F32)


def test_prefill_and_decode_leave_the_callers_cache_unchanged(f32):
    """Only a copy the caller keeps stays unchanged: prefill and decode
    write a full KV cache (or MLA's latent) in place and return it, with
    no copy of it, and SSM states come back new.  Decoding again from the
    kept copy gives the same logits and cache."""
    m, p = f32.m, f32.p
    _, tbatch = f32.batches()
    base = S + f32.cfg.meta_tokens
    cache = m.init_cache(B, base + 3)
    full = f32.cfg.family != "ssm"
    kv = (lambda c: c["self"]) if f32.cfg.family == "encdec" \
        else (lambda c: c)
    _, filled = m.prefill(p, tbatch, cache)
    assert all((a is b) == full for a, b in
               zip(Tr.tree_leaves(kv(filled)), Tr.tree_leaves(kv(cache))))
    kept = Tr.tree_map(torch.clone, filled)
    tok = torch.zeros((B, 1), dtype=torch.long)
    logits, stepped = m.decode_step(p, tok, filled, base)
    assert all((a is b) == full for a, b in
               zip(Tr.tree_leaves(kv(stepped)), Tr.tree_leaves(kv(filled))))
    assert any(not torch.equal(a, b) for a, b in
               zip(Tr.tree_leaves(stepped), Tr.tree_leaves(kept)))
    again, restepped = m.decode_step(p, tok, kept, base)
    assert torch.equal(again, logits)
    for a, b in zip(Tr.tree_leaves(restepped), Tr.tree_leaves(stepped)):
        assert torch.equal(a, b)


def test_init_draws_the_reference_distributions(f32):
    cfg = f32.cfg
    p = build_model(cfg, device="cpu").init(0)
    q = build_model(cfg, device="cpu").init(0)
    for (name, a), b in zip(p.named_parameters(), q.parameters()):
        assert torch.equal(a, b), name            # seeded
    sd = p.state_dict()
    want = {k: np.asarray(v).shape
            for k, v in _named_reference_leaves(f32.jp, cfg)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    for name, t in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "D"):                    # norms, Mamba's skip
            assert bool((t == 1).all()), name
        elif leaf in ("b", "conv_b"):                 # biases
            assert bool((t == 0).all()), name
        elif leaf == "A_log":
            assert torch.equal(t[0], torch.log(torch.arange(
                1, cfg.ssm_state + 1, dtype=torch.float32))), name
    stack = p.decoder if cfg.family == "encdec" else p.blocks
    blk = stack[0]
    w = (blk.mamba.in_proj.w if cfg.family == "ssm" else blk.attn.wq.w)
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.15
    assert abs(float(p.embed.std()) / 0.02 - 1.0) < 0.1
    if cfg.family == "moe":
        moe = blk.moe
        assert abs(float(moe.router.w.std()) / 0.02 - 1.0) < 0.2
        assert abs(float(moe.wd.std()) * cfg.expert_ff ** 0.5 - 1.0) < 0.1
        assert (moe.shared is not None) == bool(cfg.n_shared_experts)


def _named_reference_leaves(jp, cfg):
    """(port state-dict name, array) of a reference parameter pytree, its
    layer stacks unrolled into ``<stack>.<i>.``."""
    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    for name, v in walk(jp, ""):
        stack = name.split(".")[0]
        if stack in ("blocks", "encoder", "decoder"):
            rest = name[len(stack) + 1:]
            for i in range(np.asarray(v).shape[0]):
                yield f"{stack}.{i}.{rest}", np.asarray(v)[i]
        else:
            yield name, v


# ------------------------------------------------------------------ layers
def _cfg(arch, **kw):
    return (dataclasses.replace(jax_reduced(arch), dtype="float32", **kw),
            dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                                **kw))


def test_mrope_sections_match_the_reference():
    q = _x((B, 7, 4, 16), 2)
    pos = np.random.default_rng(3).integers(0, 5000, (B, 7, 3))
    for sections in ((4, 2, 2), (2, 3, 3)):
        _close(Ly.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), 1e6,
                             sections),
               jLy.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6,
                              sections), F32)


def test_mrope_with_equal_streams_is_plain_rope():
    """tests/test_model_properties.py's property on the port: M-RoPE with
    identical t / h / w streams equals plain RoPE."""
    q = torch.as_tensor(_x((1, 8, 2, 16), 4))
    p = torch.arange(8)[None]
    p3 = p[..., None].expand(1, 8, 3)
    _close(Ly.apply_rope(q, p3, 1e4, (4, 2, 2)), Ly.apply_rope(q, p, 1e4),
           dict(atol=1e-5, rtol=1e-5))
    with pytest.raises(ValueError, match="sections"):
        Ly.apply_rope(q, p, 1e4, (4, 2, 2))


def _attention_pair(arch):
    jcfg, cfg = _cfg(arch)
    jp = jLy.attention_init(jax.random.PRNGKey(5), jcfg)
    tp = load_reference_params(Ly.Attention(cfg), jax.tree.map(np.asarray,
                                                               jp))
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_vl_72b"])
def test_attention_apply_writes_and_reads_a_full_cache(arch):
    """Prefill at cache index 0 into a cache longer than the prompt, then
    a decode step at the next index: the output and the cache after each
    against the reference's (the port's cache written in place)."""
    jcfg, cfg, jp, tp = _attention_pair(arch)
    Sc, KV, hd = 20, cfg.n_kv_heads, cfg.head_dim
    x = _x((B, 9, cfg.d_model), 6)
    pos = np.broadcast_to(np.arange(9)[None], (B, 9)).copy()
    if cfg.mrope_sections:
        pos = np.repeat(pos[..., None], 3, -1)
    jc = (jnp.zeros((B, Sc, KV, hd)), jnp.zeros((B, Sc, KV, hd)))
    tc = tuple(torch.zeros((B, Sc, KV, hd)) for _ in range(2))
    j_out, jc = J_ATTN(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), kv_cache=jc,
                                    cache_index=0)
    t_out, tc_new = Ly.attention_apply(tp, cfg, torch.as_tensor(x),
                                       torch.as_tensor(pos), kv_cache=tc,
                                       cache_index=0)
    assert all(a is b for a, b in zip(tc_new, tc))          # in place
    _close(t_out, j_out, F32)
    for a, b in zip(tc, jc):
        _close(a, b, F32)
    x1 = _x((B, 1, cfg.d_model), 7)
    p1 = np.full(pos[:, :1].shape, 9)
    j_out, jc = J_ATTN(jp, jcfg, jnp.asarray(x1), jnp.asarray(p1),
                                    kv_cache=jc, cache_index=9)
    t_out, _ = Ly.attention_apply(tp, cfg, torch.as_tensor(x1),
                                  torch.as_tensor(p1), kv_cache=tc,
                                  cache_index=9)
    _close(t_out, j_out, F32)
    for a, b in zip(tc, jc):
        _close(a, b, F32)


@pytest.mark.parametrize("use_rope", [True, False])
def test_cross_attention_with_mask_none(use_rope):
    """Queries of x over the keys of ``kv_x`` at ``kv_positions``, no mask
    (the whisper decoder's cross-attention), with and without RoPE."""
    jcfg, cfg, jp, tp = _attention_pair("whisper_tiny")
    x, enc = _x((B, 5, cfg.d_model), 8), _x((B, 17, cfg.d_model), 9)
    pos = np.broadcast_to(np.arange(5)[None] + 3, (B, 5)).copy()
    epos = np.broadcast_to(np.arange(17)[None], (B, 17)).copy()
    j_out, (jk, jv) = J_ATTN(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), kv_x=jnp.asarray(enc),
        kv_positions=jnp.asarray(epos), mask_kind="none", use_rope=use_rope)
    t_out, (tk, tv) = Ly.attention_apply(
        tp, cfg, torch.as_tensor(x), torch.as_tensor(pos),
        kv_x=torch.as_tensor(enc), kv_positions=torch.as_tensor(epos),
        mask_kind="none", use_rope=use_rope)
    for a, b in ((t_out, j_out), (tk, jk), (tv, jv)):
        _close(a, b, F32)


@pytest.mark.parametrize("mask", ["causal", "none", "window"])
def test_self_attention_masks(mask):
    jcfg, cfg, jp, tp = _attention_pair("stablelm_1_6b")
    x = _x((B, 11, cfg.d_model), 10)
    pos = np.broadcast_to(np.arange(11)[None], (B, 11)).copy()
    j_out, _ = J_ATTN(jp, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos), mask_kind=mask, window=4)
    t_out, _ = Ly.attention_apply(tp, cfg, torch.as_tensor(x),
                                  torch.as_tensor(pos), mask_kind=mask,
                                  window=4)
    _close(t_out, j_out, F32)


def test_mla_apply_prefill_and_decode():
    """MLA without a cache, then prefill into the latent cache at 0 and a
    decode step at the next index, against the reference."""
    jcfg, cfg = _cfg("deepseek_v2_236b")
    jp = jLy.mla_init(jax.random.PRNGKey(6), jcfg)
    tp = load_reference_params(Ly.MLA(cfg), jax.tree.map(np.asarray, jp))
    x = _x((B, 9, cfg.d_model), 11)
    pos = np.broadcast_to(np.arange(9)[None], (B, 9)).copy()
    j_out, j_none = J_MLA(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    t_out, t_none = Ly.mla_apply(tp, cfg, torch.as_tensor(x),
                                 torch.as_tensor(pos))
    assert j_none is None and t_none is None
    _close(t_out, j_out, F32)
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    jc, tc = jnp.zeros((B, 16, width)), torch.zeros((B, 16, width))
    j_out, jc = J_MLA(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              kv_cache=jc, cache_index=0)
    t_out, t_new = Ly.mla_apply(tp, cfg, torch.as_tensor(x),
                                torch.as_tensor(pos), kv_cache=tc,
                                cache_index=0)
    assert t_new is tc
    _close(t_out, j_out, F32)
    _close(tc, jc, F32)
    x1, p1 = _x((B, 1, cfg.d_model), 12), np.full((B, 1), 9)
    j_out, jc = J_MLA(jp, jcfg, jnp.asarray(x1), jnp.asarray(p1),
                              kv_cache=jc, cache_index=9)
    t_out, _ = Ly.mla_apply(tp, cfg, torch.as_tensor(x1), torch.as_tensor(p1),
                            kv_cache=tc, cache_index=9)
    _close(t_out, j_out, F32)
    _close(tc, jc, F32)


@pytest.mark.parametrize("arch,impl,groups,capacity", [
    ("deepseek_v2_236b", "einsum", 1, 1.25),
    ("deepseek_v2_236b", "einsum", 2, 1.25),
    ("deepseek_v2_236b", "gather", 1, 1.25),
    ("deepseek_v2_236b", "einsum", 1, 0.5),
    ("deepseek_v2_236b", "gather", 1, 0.5),
    ("grok_1_314b", "einsum", 4, 0.5),
    ("grok_1_314b", "gather", 1, 1.25)])
def test_moe_apply_dispatches(arch, impl, groups, capacity):
    """The three dispatches (capacity 0.5 drops choices), shared experts
    (deepseek) or none (grok): output and aux loss against the
    reference's."""
    jcfg, cfg = _cfg(arch, moe_impl=impl, moe_groups=groups,
                     capacity_factor=capacity)
    jp = jLy.moe_init(jax.random.PRNGKey(7), jcfg)
    tp = load_reference_params(Ly.MoE(cfg), jax.tree.map(np.asarray, jp))
    x = _x((B, S, cfg.d_model), 13)
    j_out, j_aux = J_MOE(jp, jcfg, jnp.asarray(x))
    t_out, t_aux = Ly.moe_apply(tp, cfg, torch.as_tensor(x))
    _close(t_out, j_out, F32)
    _close(t_aux, j_aux, AUX)
    *_, in_cap, cap, _, _ = Ly._moe_route(tp, cfg, torch.as_tensor(
        x).reshape(-1, cfg.d_model))
    assert cap >= 1
    if capacity < 1:
        assert not bool(in_cap.all())          # the drop path is taken


def test_moe_block_aux_reaches_the_stack():
    """A moe stack's aux is the sum of its blocks' ``moe_apply`` losses."""
    jcfg, cfg = _cfg("grok_1_314b")
    jp = J_STACK_INIT(jax.random.PRNGKey(8), jcfg, 2, "moe")
    blocks = torch.nn.ModuleList(Tr.Block(cfg, "moe") for _ in range(2))
    for i, b in enumerate(blocks):
        load_reference_params(b, jax.tree.map(lambda a: np.asarray(a[i]),
                                              jp))
    x = _x((B, S, cfg.d_model), 14)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    j_x, _, j_aux = J_STACK(jp, jcfg, "moe", jnp.asarray(x),
                            jnp.asarray(pos))
    t_x, _, t_aux = Tr.stack_apply(blocks, cfg, torch.as_tensor(x),
                                   torch.as_tensor(pos))
    _close(t_x, j_x, F32)
    _close(t_aux, j_aux, AUX)


def test_encoder_matches_the_reference():
    """The whisper encoder stack (bidirectional attention, no cache)."""
    jcfg, cfg = _cfg("whisper_tiny")
    jp = J_STACK_INIT(jax.random.PRNGKey(9), jcfg, cfg.enc_layers,
                      "enc")
    blocks = torch.nn.ModuleList(Tr.Block(cfg, "enc")
                                 for _ in range(cfg.enc_layers))
    for i, b in enumerate(blocks):
        load_reference_params(b, jax.tree.map(lambda a: np.asarray(a[i]),
                                              jp))
    x = _x((B, cfg.enc_positions, cfg.d_model), 15)
    pos = np.broadcast_to(np.arange(cfg.enc_positions)[None],
                          (B, cfg.enc_positions)).copy()
    j_x, _, _ = J_STACK(jp, jcfg, "enc", jnp.asarray(x), jnp.asarray(pos))
    t_x, none, aux = Tr.stack_apply(blocks, cfg, torch.as_tensor(x),
                                    torch.as_tensor(pos))
    assert none is None and aux == 0.0
    _close(t_x, j_x, F32)


@pytest.mark.parametrize("kind", ["dense", "moe", "ssm", "enc", "dec"])
def test_block_keys_are_the_references(kind):
    arch = {"dense": "qwen2_72b", "moe": "deepseek_v2_236b",
            "ssm": "falcon_mamba_7b", "enc": "whisper_tiny",
            "dec": "whisper_tiny"}[kind]
    jcfg, cfg = _cfg(arch)
    jp = jax.eval_shape(lambda k: jTr.block_init(k, jcfg, kind),
                        jax.random.PRNGKey(10))
    flat = dict(_named_reference_leaves(jp, cfg))
    sd = Tr.Block(cfg, kind).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}


def test_unknown_block_kind_and_family_raise():
    cfg = configs.get_reduced("internlm2_1_8b")
    with pytest.raises(ValueError, match="block kind"):
        Tr.Block(cfg, "rnn")
    with pytest.raises(ValueError, match="family"):
        build_model(dataclasses.replace(cfg, family="rnn"), device="cpu")
    assert {configs.get_config(a).family for a in configs.ARCH_IDS} == \
        set(PORTED_FAMILIES)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b",
                                  "whisper-tiny", "qwen2-vl-72b",
                                  "deepseek-v2-236b"])
def test_serve_cli_serves_every_family_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt", "12", "--tokens", "3"])
    out = capsys.readouterr().out
    name = configs.get_reduced(arch).name
    assert f"arch={name} device=cpu" in out and "tok/s" in out


def test_stub_inputs_follow_the_family():
    gen = torch.Generator().manual_seed(1)
    enc = serve.stub_inputs(configs.get_reduced("whisper-tiny"), 2, 9, gen)
    assert tuple(enc["audio_embeds"].shape) == (2, 32, 64)
    vlm = serve.stub_inputs(configs.get_reduced("qwen2-vl-72b"), 2, 9, gen)
    assert tuple(vlm["patch_embeds"].shape) == (2, serve.VLM_PATCHES, 64)
    assert torch.equal(vlm["positions"][1, :, 2], torch.arange(9))
    assert serve.stub_inputs(configs.get_reduced("grok-1-314b"), 2, 9,
                             gen) == {}
