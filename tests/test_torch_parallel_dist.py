"""The port's multi-rank layer on 4 gloo ranks of this host (the ranks:
``tests/torch_dist_worker.py``), held against the reference:

* the GPipe pipeline (``parallel.pipeline``) over a (4,) "stage" mesh
  against the reference's sequential program at the same weights (the
  program of ``tests/test_substrates.py``'s pipeline case, run without
  its ``pipeline_forward``: that case fails under this JAX when it takes
  ``jax.grad`` through the pipeline), outputs to 1e-5 and the gradients
  of sum(out^2) against ``jax.grad`` of the sequential program to 1e-4;
* a reduced dense (internlm2) and a reduced hybrid (hymba) model whose
  parameters are DTensors on a (2, 2) ("data", "model") mesh, through the
  kernels' sharding rules and the activation-sharding context, against
  the unsharded forward to 1e-5;
* the dense model's greedy generation with its KV cache's sequence
  sharded over the model axis (flash-decoding's partial softmax) against
  the plain generation, tokens equal and logits to 1e-5;
* the reduced hybrid model's loss gradients with DTensor parameters
  (the kernels' backward rules) against the unsharded ones, within 1e-5
  of each tensor's largest;
* elastic restore: parameters saved as DTensors from (data 2, model 2)
  restored on 2 ranks (a (2, 1) mesh) and in one process, bit for bit.

The ranks are spawned once for the module (two worlds: 4 ranks, then 2)."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.models.model import build_model, lm_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, MB, M = 8, 16, 4, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(case: str, world: int, out_dir) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         case, str(world), str(out_dir), str(_free_port())],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    np.savez(out / "pipe.npz", w=w, x=x)
    _spawn("four", 4, out)
    _spawn("restore", 2, out)
    four = [dict(np.load(out / f"four_{r}.npz")) for r in range(4)]
    two = [dict(np.load(out / f"restore_{r}.npz")) for r in range(2)]
    return dict(dir=out, w=w, x=x, four=four, two=two)


def _seq(w, xs):
    """The reference's sequential program: every microbatch through all
    layers, tanh(x @ w_l)."""
    def body(h, wl):
        return jnp.tanh(h @ wl), None
    return jnp.stack([jax.lax.scan(body, xs[i], w)[0]
                      for i in range(xs.shape[0])])


def test_pipeline_forward_matches_sequential(runs):
    ref = np.asarray(_seq(jnp.asarray(runs["w"]), jnp.asarray(runs["x"])))
    for r in range(4):                       # every stage holds the output
        np.testing.assert_allclose(runs["four"][r]["pipe_out"], ref,
                                   atol=1e-5, rtol=1e-5)


def test_pipeline_gradients_match_jax_grad(runs):
    x = jnp.asarray(runs["x"])
    g = np.asarray(jax.grad(lambda w: jnp.sum(_seq(w, x) ** 2))(
        jnp.asarray(runs["w"])))
    got = np.concatenate([runs["four"][r]["pipe_grad"] for r in range(4)])
    np.testing.assert_allclose(got, g, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["internlm2", "hymba"])
def test_sharded_forward_matches_unsharded(runs, arch):
    for r in range(4):
        z = runs["four"][r]
        assert z[f"{arch}_sharded"].shape == z[f"{arch}_plain"].shape
        np.testing.assert_allclose(z[f"{arch}_sharded"], z[f"{arch}_plain"],
                                   atol=1e-5, rtol=1e-5)
        # the embedding is 2-D sharded: vocab over model, d over data
        assert list(z[f"{arch}_placements"]) == ["Shard(dim=1)",
                                                  "Shard(dim=0)"]
        assert list(z["mesh_shape"]) == [2, 2]      # make_host_mesh(2)


def test_sequence_sharded_decode_matches_unsharded(runs):
    """Prefill into a KV cache whose sequence is split over the model axis
    (each rank writes its block), then decode by partial softmax over the
    blocks: the plain generation's tokens, and its logits to 1e-5."""
    for r in range(4):
        z = runs["four"][r]
        np.testing.assert_array_equal(z["dec_tokens"], z["dec_tokens_plain"])
        np.testing.assert_allclose(z["dec_logits"], z["dec_logits_plain"],
                                   atol=1e-5, rtol=1e-5)
        # (L, B, S, KV, hd): the batch over data, the sequence over model
        assert list(z["dec_cache_placements"]) == ["Shard(dim=1)",
                                                   "Shard(dim=2)"]


def test_sharded_gradients_match_unsharded(runs):
    """The reduced hymba's loss gradients with DTensor parameters on the
    (2, 2) mesh — the attention and scan backward through their sharding
    rules, the sums over a sharded dim as partial sums — against the
    unsharded gradients, within 1e-5 of each tensor's largest."""
    for r in range(4):
        z = runs["four"][r]
        names = [k[len("grad/"):] for k in z if k.startswith("grad/")]
        assert len(names) > 20
        for n in names:
            want = z[f"grad_plain/{n}"]
            np.testing.assert_allclose(
                z[f"grad/{n}"], want, rtol=1e-5,
                atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
                err_msg=n)


def _saved_params():
    return build_model(get_reduced("internlm2-1.8b"), "cpu").init(0)


def test_checkpoint_from_four_ranks_restores_on_two(runs):
    want = dict(_saved_params().named_parameters())
    for z in runs["two"]:
        assert int(z["n_dtensor"]) == len(want)
        for n, p in want.items():
            np.testing.assert_array_equal(z[f"full/{n}"], p.detach().numpy())
        assert int(z["step"]) == 7
        np.testing.assert_array_equal(
            z["mu_embed"], want["embed"].detach().numpy() * 0.5)


def test_checkpoint_from_four_ranks_restores_in_one_process(runs):
    cfg = get_reduced("internlm2-1.8b")
    params = lm_module(cfg, "cpu")
    state = {"params": params,
             "opt": {"step": torch.tensor(0, dtype=torch.int32),
                     "mu": {"embed": torch.zeros_like(params.embed)}}}
    mgr = CheckpointManager(runs["dir"] / "ckpt")
    assert mgr.latest_step() == 1
    mgr.restore(1, state)
    for n, p in _saved_params().named_parameters():
        assert torch.equal(dict(params.named_parameters())[n], p), n
    assert int(state["opt"]["step"]) == 7
    # each rank held its own shard of the embedding before the save
    shards = [runs["four"][r]["local_embed"] for r in range(4)]
    assert all(s.shape == (cfg.padded_vocab // 2, cfg.d_model // 2)
               for s in shards)
