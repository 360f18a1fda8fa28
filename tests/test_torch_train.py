"""The port's training slice against the JAX reference on the CPU:
``data.pipeline`` (batches bit-identical), ``optim.adamw`` and
``optim.compress`` (on the same numpy trees), ``checkpoint.manager``,
``runtime.driver`` / ``runtime.straggler`` (the reference's substrate tests,
``tests/test_substrates.py``, case for case), and ``Model.loss`` with
``launch.train.make_train_step`` on reduced configs of five families.

Tolerances (float32 throughout):
* a loss within rtol 1e-6 and the gradient norm within rtol 1e-5: both
  packages run float32, only the order of sums differs;
* each gradient within 2e-5 of its tensor's largest magnitude, plus rtol
  1e-4;
* the parameters after one AdamW step (lr 1e-3) within 1e-4: the first
  step moves a weight by lr g / (|g| + eps), so where |g| is at the
  gradients' float32 noise the move differs (measured up to 3.2e-5);
* AdamW on fixed trees: parameters within 1e-6, moments within rtol 1e-5
  (float32: the clip scale comes from the norm, whose sum runs in another
  order) or one bf16 rounding (bfloat16).
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpoints
from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.train import make_train_state as jax_train_state
from repro.launch.train import make_train_step as jax_train_step
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import (lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as T
from repro_torch.models import transformer as Tr
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, compress
from repro_torch.runtime.driver import FaultTolerantTrainer, TransientError
from repro_torch.runtime.straggler import StragglerMonitor

LOSS_RTOL = 1e-6
GN_RTOL = 1e-5
GRAD_ATOL_OF_MAX, GRAD_RTOL = 2e-5, 1e-4
PARAM_ATOL = 1e-4


# ---------------------------------------------------------------------------
# data pipeline: bit-identical batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (97, 32, 8, 1234, (0, 1)), (32001, 64, 4, 1234, (0, 1)),
    (256, 16, 8, 7, (1, 2)), (1000, 24, 6, 3, (2, 3))])
def test_synthetic_batches_are_the_references_bitwise(vocab, seq, batch,
                                                      seed, hosts):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
              host_id=hosts[0], n_hosts=hosts[1])
    a, b = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    assert a.host_batch == b.host_batch
    for step in (0, 1, 17, 1000):
        x, y = a.batch_at(step), b.batch_at(step)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    got = [s["tokens"] for s in a.stream(5, 2)]
    np.testing.assert_array_equal(got[1], b.batch_at(6)["tokens"])


# ---------------------------------------------------------------------------
# AdamW, schedules, norms, clipping; int8 compression
# ---------------------------------------------------------------------------
def _tree(seed, shapes=(("w", (4, 3)), ("b", (3,)), ("e", (5, 2)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes}


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_schedule_lr_matches_the_reference(schedule):
    cfg = dict(lr=3e-4, schedule=schedule, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        want = float(jadamw.schedule_lr(jadamw.AdamWConfig(**cfg),
                                        jnp.asarray(step, jnp.int32)))
        got = adamw.schedule_lr(adamw.AdamWConfig(**cfg), step)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_global_norm_matches_the_reference():
    t = _tree(1)
    want = float(jadamw.global_norm({k: jnp.asarray(v) for k, v in t.items()}))
    got = float(adamw.global_norm({k: torch.tensor(v) for k, v in t.items()}))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 0.05, 0.0])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_update_matches_the_reference(moment_dtype, clip_norm,
                                            schedule):
    kw = dict(lr=1e-2, moment_dtype=moment_dtype, clip_norm=clip_norm,
              schedule=schedule, warmup_steps=2, total_steps=6,
              weight_decay=0.1)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p0 = _tree(2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jo, to = jadamw.adamw_init(jcfg, jp), adamw.adamw_init(cfg, tp)
    for step in range(5):
        g = _tree(10 + step)
        jp, jo, jm = jadamw.adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jo, jp)
        tp, to, tm = adamw.adamw_update(
            cfg, {k: torch.tensor(v) for k, v in g.items()}, to, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
            for key in ("mu", "nu"):
                a = to[key][k].float().numpy()
                b = np.asarray(jo[key][k], np.float32)
                tol = 1e-5 if moment_dtype == "float32" else 2 ** -8
                np.testing.assert_allclose(a, b, atol=1e-12, rtol=tol)
    assert int(to["step"]) == int(jo["step"]) == 5
    assert to["mu"]["w"].dtype == getattr(torch, moment_dtype)


def test_adamw_chunks_give_the_same_update(monkeypatch):
    """The update's chunking of the parameter list changes no bit."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    p0, g = _tree(3), _tree(4)

    def run():
        p = {k: torch.tensor(v) for k, v in p0.items()}
        o = adamw.adamw_init(cfg, p)
        adamw.adamw_update(cfg, {k: torch.tensor(v) for k, v in g.items()},
                           o, p)
        return p, o
    whole = run()
    monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", 5)
    parts = run()
    for k in p0:
        assert torch.equal(whole[0][k], parts[0][k])
        assert torch.equal(whole[1]["mu"][k], parts[1]["mu"][k])


def test_int8_compression_matches_the_reference():
    grads = _tree(5)
    err = {k: (0.01 * v).astype(np.float32) for k, v in _tree(6).items()}
    jq, js, je = jcompress.compress_grads(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in err.items()})
    tq, ts, te = compress.compress_grads(
        {k: torch.tensor(v) for k, v in grads.items()},
        {k: torch.tensor(v) for k, v in err.items()})
    for k in grads:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=1e-7)
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   atol=1e-7)
    deq = compress.decompress_grads(tq, ts)
    jdeq = jcompress.decompress_grads(jq, js)
    for k in grads:
        np.testing.assert_allclose(deq[k].numpy(), np.asarray(jdeq[k]),
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the reference's substrate tests (tests/test_substrates.py), on the port
# ---------------------------------------------------------------------------
def _data_deterministic_and_resumable():
    cfg = DataConfig(vocab=97, seq_len=32, global_batch=8)
    a, b = SyntheticLM(cfg), SyntheticLM(cfg)
    for s in (0, 5, 1000):
        np.testing.assert_array_equal(a.batch_at(s)["tokens"],
                                      b.batch_at(s)["tokens"])
    assert not np.array_equal(a.batch_at(1)["tokens"],
                              a.batch_at(2)["tokens"])


def _data_host_sharding_disjoint():
    h0 = SyntheticLM(DataConfig(vocab=97, seq_len=16, global_batch=8,
                                host_id=0, n_hosts=2))
    h1 = SyntheticLM(DataConfig(vocab=97, seq_len=16, global_batch=8,
                                host_id=1, n_hosts=2))
    assert h0.host_batch == 4 and h1.host_batch == 4
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])


def _data_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab=97, seq_len=16,
                               global_batch=2)).batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["loss_mask"][:, -1].sum() == 0


@pytest.mark.parametrize("case", [_data_deterministic_and_resumable,
                                  _data_host_sharding_disjoint,
                                  _data_labels_are_shifted_tokens],
                         ids=lambda f: f.__name__.strip("_"))
def test_data_substrate(case):
    case()


def _quadratic(moment_dtype, steps):
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            schedule="constant", moment_dtype=moment_dtype)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.adamw_init(cfg, params)
    assert opt["mu"]["w"].dtype == getattr(torch, moment_dtype)
    for _ in range(steps):
        params, opt, _ = adamw.adamw_update(cfg, {"w": 2 * params["w"]}, opt,
                                            params)
    return float(params["w"].abs().max())


def _adamw_converges_on_quadratic():
    assert _quadratic("float32", 200) < 1e-2


def _adamw_bf16_moments_still_converge():
    assert _quadratic("bfloat16", 300) < 5e-2


def _grad_clip_limits_update_norm():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0,
                            warmup_steps=0, schedule="constant")
    params = {"w": torch.ones(4)}
    opt = adamw.adamw_init(cfg, params)
    _, _, m = adamw.adamw_update(cfg, {"w": torch.full((4,), 1e6)}, opt,
                                 params)
    assert float(m["grad_norm"]) > 1e5     # raw norm reported


def _int8_compression_with_error_feedback_converges():
    w = torch.tensor([4.0, -2.0, 1.0])
    err = compress.init_error_state({"w": w})
    for _ in range(300):
        q, s, err = compress.compress_grads({"w": 2 * w}, err)
        w = w - 0.05 * compress.decompress_grads(q, s)["w"]
    assert float(w.abs().max()) < 1e-2


def _int8_quantization_bounded_error():
    x = torch.linspace(-3, 3, 101)
    q, s = compress.quantize_int8(x)
    assert q.dtype == torch.int8
    assert float((compress.dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) / 2 + 1e-6


@pytest.mark.parametrize("case", [_adamw_converges_on_quadratic,
                                  _adamw_bf16_moments_still_converge,
                                  _grad_clip_limits_update_norm,
                                  _int8_compression_with_error_feedback_converges,
                                  _int8_quantization_bounded_error],
                         ids=lambda f: f.__name__.strip("_"))
def test_optimizer_substrate(case):
    case()


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "b": torch.zeros(3)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": {"w": torch.randn(4, 3, generator=g).to(
                        torch.bfloat16)}}}


def _checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path)
    st = _tiny_state()
    cm.save(10, st, blocking=True)
    assert cm.latest_step() == 10
    out = cm.restore(10, _tiny_state(1))
    np.testing.assert_allclose(out["params"]["w"], st["params"]["w"])
    assert int(out["opt"]["step"]) == 7
    assert out["opt"]["mu"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["opt"]["mu"]["w"], st["opt"]["mu"]["w"])
    meta = json.loads((Path(tmp_path) / "step_000000010" /
                       "meta.json").read_text())
    assert meta["dtypes"]["opt/mu/w"] == "bfloat16"


def _checkpoint_async_and_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tiny_state(s))
    cm.wait()
    assert cm.latest_step() == 4
    steps = sorted(int(p.name.split("_")[1])
                   for p in Path(tmp_path).glob("step_*"))
    assert len(steps) <= 2


def _checkpoint_skips_torn_save(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(5, _tiny_state(), blocking=True)
    torn = Path(tmp_path) / "step_000000009"
    torn.mkdir()
    (torn / "meta.json").write_text("{}")      # no COMMIT marker
    assert cm.latest_step() == 5


def _checkpoint_detects_corruption(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(3, _tiny_state(), blocking=True)
    d = Path(tmp_path) / "step_000000003"
    flat = dict(np.load(d / "shard_00000.npz"))
    flat["params/w"] = flat["params/w"] + 1.0
    np.savez(d / "shard_00000.npz", **flat)
    with pytest.raises(IOError):
        cm.restore(3, _tiny_state())


def _checkpoint_saves_what_it_was_given(tmp_path):
    """A save copies to the host before it returns: updating the state in
    place right after (as a train step does) does not reach the files."""
    cm = CheckpointManager(tmp_path)
    st = _tiny_state()
    want = st["params"]["w"].clone()
    cm.save(1, st)
    st["params"]["w"].add_(1.0)
    cm.wait()
    assert torch.equal(cm.restore(1, _tiny_state(2))["params"]["w"], want)


def _checkpoint_of_a_module_restores_in_place(tmp_path):
    cfg = configs.get_reduced("internlm2_1_8b")
    m = build_model(cfg, "cpu")
    st = T.make_train_state(m, 0, adamw.AdamWConfig())
    cm = CheckpointManager(tmp_path)
    cm.save(0, st, blocking=True)
    other = T.make_train_state(m, 1, adamw.AdamWConfig())
    out = cm.restore(0, other)
    assert out is other
    for a, b in zip(st["params"].parameters(), other["params"].parameters()):
        assert torch.equal(a, b) and b.requires_grad


@pytest.mark.parametrize("case", [_checkpoint_roundtrip,
                                  _checkpoint_async_and_gc,
                                  _checkpoint_skips_torn_save,
                                  _checkpoint_detects_corruption,
                                  _checkpoint_saves_what_it_was_given,
                                  _checkpoint_of_a_module_restores_in_place],
                         ids=lambda f: f.__name__.strip("_"))
def test_checkpoint_substrate(case, tmp_path):
    case(tmp_path)


def test_checkpoints_mix_with_neither_package(tmp_path):
    """The port writes the reference's layout (step dirs, one npz shard,
    meta.json checksums, COMMIT), so the reference's manager sees its
    commits."""
    CheckpointManager(tmp_path).save(4, _tiny_state(), blocking=True)
    assert JCheckpoints(tmp_path).latest_step() == 4


def _toy_problem():
    def train_step(state, batch):
        w = state["params"]["w"].detach().requires_grad_()
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        loss.backward()
        with torch.no_grad():
            state["params"]["w"].sub_(0.1 * w.grad)
        return state, {"loss": loss.detach()}

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(3, 1))

    def batch_at(step):
        r = np.random.default_rng(step)
        x = r.normal(size=(16, 3)).astype(np.float32)
        return {"x": torch.tensor(x),
                "y": torch.tensor((x @ w_true).astype(np.float32))}

    return train_step, batch_at, {"params": {"w": torch.zeros((3, 1))}}


def _driver_trains_and_checkpoints(tmp_path):
    step_fn, batch_at, state = _toy_problem()
    tr = FaultTolerantTrainer(step_fn, CheckpointManager(tmp_path),
                              ckpt_every=10)
    rep, state = tr.run(state, batch_at, num_steps=40)
    assert rep.losses[-1] < rep.losses[0] * 0.2
    assert tr.ckpt.latest_step() is not None


def _driver_recovers_from_transient_faults(tmp_path):
    step_fn, batch_at, state = _toy_problem()
    boom = {25}

    def fault(step):
        if step in boom:
            boom.clear()
            raise TransientError("injected")

    tr = FaultTolerantTrainer(step_fn, CheckpointManager(tmp_path),
                              ckpt_every=10, fault_hook=fault)
    rep, state = tr.run(state, batch_at, num_steps=40)
    assert rep.restarts == 1
    assert rep.end_step == 40


def _driver_resumes_across_process_restart(tmp_path):
    step_fn, batch_at, state = _toy_problem()
    tr1 = FaultTolerantTrainer(step_fn, CheckpointManager(tmp_path),
                               ckpt_every=5)
    rep1, _ = tr1.run(state, batch_at, num_steps=20)
    step_fn2, batch_at2, fresh = _toy_problem()
    tr2 = FaultTolerantTrainer(step_fn2, CheckpointManager(tmp_path),
                               ckpt_every=5)
    rep2, final = tr2.run(fresh, batch_at2, num_steps=10)
    assert rep2.start_step == 20            # resumed, not restarted
    assert rep2.losses[0] < rep1.losses[0]  # picked up trained weights


def _driver_restores_before_it_retries(tmp_path):
    """The retried step starts from the last checkpoint: a fault after the
    state was half updated leaves no trace."""
    step_fn, batch_at, state = _toy_problem()
    seen = []

    def fault(step):
        if step == 7 and not seen:
            seen.append(1)
            state["params"]["w"].add_(100.0)       # a half-done update
            raise TransientError("injected")

    tr = FaultTolerantTrainer(step_fn, CheckpointManager(tmp_path),
                              ckpt_every=5, fault_hook=fault)
    rep, st = tr.run(state, batch_at, num_steps=10)
    assert rep.restarts == 1 and float(st["params"]["w"].abs().max()) < 10


@pytest.mark.parametrize("case", [_driver_trains_and_checkpoints,
                                  _driver_recovers_from_transient_faults,
                                  _driver_resumes_across_process_restart,
                                  _driver_restores_before_it_retries],
                         ids=lambda f: f.__name__.strip("_"))
def test_driver_substrate(case, tmp_path):
    case(tmp_path)


def test_straggler_flags_outliers_only():
    m = StragglerMonitor()
    flags = [m.observe(i, 0.1 + 0.001 * (i % 3)) for i in range(30)]
    assert not any(flags)
    assert m.observe(30, 1.5)               # 15x the mean
    assert not m.observe(31, 0.1)


# ---------------------------------------------------------------------------
# Model.loss and make_train_step against the reference
# ---------------------------------------------------------------------------
# reduced configs of five families: hybrid, dense, moe (MLA, aux loss on),
# moe (GQA), ssm, encdec
TRAIN_ARCHS = ["hymba_1_5b", "internlm2_1_8b", "deepseek_v2_236b",
               "grok_1_314b", "falcon_mamba_7b", "whisper_tiny"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 2, 16


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


class TrainPair:
    """One reduced architecture in both packages, float32, one state."""

    def __init__(self, arch):
        self.jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
        self.cfg = dataclasses.replace(configs.get_reduced(arch),
                                       dtype="float32")
        self.jm = jax_build(self.jcfg)
        self.m = build_model(self.cfg, "cpu")
        self.jstate = jax_train_state(self.jm, jax.random.PRNGKey(0),
                                      jadamw.AdamWConfig(**OPT))
        rng = np.random.default_rng(1)
        self.batch = {"tokens": rng.integers(0, self.cfg.vocab, (B, S))
                      .astype(np.int32)}
        if self.cfg.family == "encdec":
            self.batch["audio_embeds"] = rng.standard_normal(
                (B, self.cfg.enc_positions, self.cfg.d_model)).astype(
                np.float32)

    def state(self):
        return train_state_from_reference(
            jax.tree.map(np.asarray, self.jstate), self.cfg, "cpu")

    def jbatch(self, batch=None):
        return {k: jnp.asarray(v) for k, v in (batch or self.batch).items()}

    def as_module(self, tree):
        return dict(lm_params_from_reference(jax.tree.map(np.asarray, tree),
                                             self.cfg, "cpu")
                    .named_parameters())


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return TrainPair(arch)


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def pair(request):
    return _pair(request.param)


def test_loss_and_gradients_match_the_reference(pair):
    (jl, jparts), jg = jax.value_and_grad(pair.jm.loss, has_aux=True)(
        pair.jstate["params"], pair.jbatch())
    st = pair.state()
    loss, parts = pair.m.loss(st["params"], pair.batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(parts["aux"]) == pytest.approx(float(jparts["aux"]),
                                                rel=LOSS_RTOL, abs=1e-7)
    if pair.cfg.family == "moe":
        assert float(parts["aux"]) > 0
    want = pair.as_module(jg)
    for n, p in st["params"].named_parameters():
        w = want[n].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * float(np.abs(w).max()), err_msg=n)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(pair, microbatches):
    step = jax.jit(jax_train_step(pair.jm, jadamw.AdamWConfig(**OPT),
                                  microbatches))
    jst, jm = step(pair.jstate, pair.jbatch())
    st, m = T.make_train_step(pair.m, adamw.AdamWConfig(**OPT),
                              microbatches)(pair.state(), pair.batch)
    for key in ("loss", "xent", "aux"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=LOSS_RTOL,
                                              abs=1e-7), key
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GN_RTOL)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    want = pair.as_module(jst["params"])
    for n, p in st["params"].named_parameters():
        np.testing.assert_allclose(_np(p), _np(want[n]), atol=PARAM_ATOL,
                                   err_msg=n)
    assert int(st["opt"]["step"]) == 1
    assert all(p.grad is None for p in st["params"].parameters())


def test_train_state_from_reference_carries_the_moments():
    pair = _pair("internlm2_1_8b")
    jst, _ = jax.jit(jax_train_step(pair.jm, jadamw.AdamWConfig(**OPT)))(
        pair.jstate, pair.jbatch())
    st = train_state_from_reference(jax.tree.map(np.asarray, jst), pair.cfg,
                                    "cpu")
    want = pair.as_module(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jst["opt"]["mu"]))
    assert int(st["opt"]["step"]) == 1
    for n, m in st["opt"]["mu"].items():
        assert m.dtype == torch.bfloat16
        np.testing.assert_array_equal(m.float().numpy(),
                                      want[n].detach().numpy())


@pytest.mark.parametrize("remat,group", [("none", 0), ("full", 0),
                                         ("dots", 1), ("dots", 0)])
def test_remat_policies_give_the_same_gradients(remat, group):
    """Checkpointed groups recompute the same function: every policy and
    group size gives the un-checkpointed gradients, and the layer groups
    follow the reference's sqrt rule."""
    base = dataclasses.replace(configs.get_reduced("hymba_1_5b"),
                               dtype="float32", n_layers=4)
    grads = {}
    for name, cfg in (("none", dataclasses.replace(base, remat="none")),
                      (remat, dataclasses.replace(base, remat=remat,
                                                  remat_group=group))):
        m = build_model(cfg, "cpu")
        st = T.make_train_state(m, 0, adamw.AdamWConfig())
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=12,
                                       global_batch=2)).batch_at(0)
        loss, _ = m.loss(st["params"], batch)
        loss.backward()
        grads[name] = {n: p.grad for n, p in st["params"].named_parameters()}
    for n, g in grads["none"].items():
        np.testing.assert_allclose(grads[remat][n].numpy(), g.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)
    assert [Tr.remat_group(L) for L in (1, 2, 4, 32, 24, 80)] == \
        [1, 2, 2, 4, 4, 8]


def test_serving_stays_without_autograd():
    """forward / prefill run under no_grad and never take the training
    path, even with parameters that take gradients."""
    cfg = configs.get_reduced("hymba_1_5b")
    m = build_model(cfg, "cpu")
    st = T.make_train_state(m, 0, adamw.AdamWConfig())
    toks = np.zeros((1, 8), np.int32)
    assert m.forward(st["params"], {"tokens": toks}).grad_fn is None
    lg, _ = m.prefill(st["params"], {"tokens": toks}, m.init_cache(1, 32))
    assert lg.grad_fn is None


def test_eval_step_and_train_loop():
    cfg = configs.get_reduced("internlm2_1_8b")
    m = build_model(cfg, "cpu")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1)
    st = T.make_train_state(m, 0, opt)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4))
    seen = []
    res, st = T.train_loop(m, st, data.stream(0, 12), T.make_train_step(
        m, opt), log_every=0, on_step=lambda i, s, met: seen.append(i))
    assert res.steps == 12 and seen == list(range(12))
    assert res.losses[-1] < res.losses[0]
    ev = T.make_eval_step(m)(st["params"], data.batch_at(99))
    assert set(ev) == {"loss", "xent", "aux"} and ev["loss"].grad_fn is None


def test_train_cli_on_the_cpu(tmp_path, capsys):
    rep = T.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                  "--steps", "25", "--batch", "4", "--seq", "16",
                  "--ckpt-dir", str(tmp_path)])
    assert rep.end_step == 25 and rep.losses[-1] < rep.losses[0]
    assert CheckpointManager(tmp_path).latest_step() == 24
    assert "trained steps 0..25" in capsys.readouterr().out


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
