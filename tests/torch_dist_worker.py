"""The ranks of the port's multi-rank CPU tests (``tests/test_torch_parallel
_dist.py``): ``python tests/torch_dist_worker.py CASE WORLD DIR PORT``
starts WORLD gloo ranks on this host (``tcp://localhost:PORT``), runs
CASE on each and writes each rank's readings to ``DIR/<case>_<rank>.npz``.

* ``four`` (4 ranks): the GPipe pipeline over a (4,) "stage" mesh on the
  program of ``DIR/pipe.npz`` (forward outputs, and each stage's gradient
  of sum(out^2)); a reduced dense and a reduced hybrid model's forward
  with DTensor parameters on a (2, 2) ("data", "model") mesh; the dense
  model's greedy generation with a sequence-sharded KV cache; the hybrid
  model's loss gradients with DTensor parameters; the dense model's
  parameters saved as DTensors to ``DIR/ckpt`` (step 1);
* ``restore`` (any world): the checkpoint of step 1 restored into a plain
  module laid out on a (WORLD, 1) mesh by the sharding rules, each leaf
  written back whole.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LM_ARCHS = ("internlm2-1.8b", "hymba-1.5b")


def _pipeline(out_dir: str, rank: int) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    z = np.load(os.path.join(out_dir, "pipe.npz"))
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("stage",))
    w = torch.tensor(z["w"], requires_grad=True)
    x = torch.tensor(z["x"])
    mine = split_stages(w, 4)[rank]

    def stage_fn(p, h):
        for i in range(p.shape[0]):
            h = torch.tanh(h @ p[i])
        return h
    out = pipeline_forward(stage_fn, mesh, "stage", mine, x)
    (out ** 2).sum().backward()
    return {"pipe_out": out.detach().numpy(),
            "pipe_grad": w.grad[rank * 2:(rank + 1) * 2].numpy()}


def _sharded_lm(rank: int) -> dict:
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as Sh
    from repro_torch.parallel.ctx import activation_sharding
    mesh = make_host_mesh(model_parallel=2, device="cpu")   # (2, 2)
    pc = ParallelConfig()
    out = {}
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        model = build_model(cfg, "cpu")
        params = model.init(0)
        tokens = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, (4, 16)), dtype=torch.int32)
        plain = model.forward(params, {"tokens": tokens})
        Sh.distribute_module(params, cfg, mesh, Sh.make_rules(pc))
        with activation_sharding(mesh, pc):
            sharded = model.forward(params, {"tokens": tokens})
        key = arch.split("-")[0]
        out[f"{key}_plain"] = plain.numpy()
        out[f"{key}_sharded"] = sharded.full_tensor().numpy()
        out[f"{key}_placements"] = np.array(
            [repr(p) for p in params.embed.placements])
    out["mesh_shape"] = np.array(tuple(mesh.shape))
    return out


def _sharded_decode(rank: int) -> dict:
    """Greedy generation of a reduced internlm2 with its KV cache's
    sequence sharded over the model axis (``decode_kv="sequence"``):
    prefill writes each rank's block, decode attends by partial softmax."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as Sh
    from repro_torch.parallel.ctx import activation_sharding
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    pc = ParallelConfig(decode_kv="sequence")
    cfg = dataclasses.replace(get_reduced(LM_ARCHS[0]), dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(0)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 13)), dtype=torch.int32)
    plain = generate(model, params, prompt, 6)
    Sh.distribute_module(params, cfg, mesh, Sh.make_rules(pc))
    with activation_sharding(mesh, pc):
        cache = model.init_cache(4, 8)
        sharded = generate(model, params, prompt, 6)
    return {"dec_tokens_plain": plain.tokens.numpy(),
            "dec_tokens": sharded.tokens.full_tensor().numpy(),
            "dec_logits_plain": plain.logits.numpy(),
            "dec_logits": sharded.logits.full_tensor().numpy(),
            "dec_cache_placements": np.array(
                [repr(p) for p in cache[0].placements])}


def _sharded_grads(rank: int) -> dict:
    """A reduced hymba's loss gradients with DTensor parameters on the
    (2, 2) mesh (the attention and scan backward through their sharding
    rules), and without."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as Sh
    from repro_torch.parallel.ctx import activation_sharding
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    pc = ParallelConfig()
    cfg = dataclasses.replace(get_reduced(LM_ARCHS[1]), dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(0)
    params.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16)), dtype=torch.int32)}
    model.loss(params, batch)[0].backward()
    plain = {n: p.grad.clone() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    Sh.distribute_module(params, cfg, mesh, Sh.make_rules(pc))
    with activation_sharding(mesh, pc):
        model.loss(params, batch)[0].backward()
    out = {}
    for n, p in params.named_parameters():
        out[f"grad_plain/{n}"] = plain[n].numpy()
        out[f"grad/{n}"] = p.grad.full_tensor().numpy()
    return out


def _save(out_dir: str, rank: int) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as Sh
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    cfg = get_reduced(LM_ARCHS[0])
    params = build_model(cfg, "cpu").init(0)
    Sh.distribute_module(params, cfg, mesh, Sh.make_rules(ParallelConfig()))
    state = {"params": params,
             "opt": {"step": torch.tensor(7, dtype=torch.int32),
                     "mu": {"embed": params.embed.detach() * 0.5}}}
    CheckpointManager(os.path.join(out_dir, "ckpt")).save(1, state,
                                                          blocking=True)
    dist.barrier()
    return {"local_embed": params.embed.to_local().numpy()}


def _restore(out_dir: str, rank: int, world: int) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import lm_module
    from repro_torch.parallel import sharding as Sh
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"))
    cfg = get_reduced(LM_ARCHS[0])
    params = lm_module(cfg, "cpu")
    lay = {f"params/{n}": (mesh, pl) for n, pl in Sh.param_shardings(
        params, cfg, mesh, Sh.make_rules(ParallelConfig())).items()}
    state = {"params": params,
             "opt": {"step": torch.tensor(0, dtype=torch.int32),
                     "mu": {"embed": torch.zeros_like(params.embed)}}}
    CheckpointManager(os.path.join(out_dir, "ckpt")).restore(1, state, lay)
    out = {f"full/{n}": p.full_tensor().numpy()
           for n, p in params.named_parameters()}
    out["n_dtensor"] = np.array(sum(
        type(p.data).__name__ == "DTensor" for p in params.parameters()))
    out["step"] = state["opt"]["step"].numpy()
    out["mu_embed"] = state["opt"]["mu"]["embed"].numpy()
    return out


def _rank(rank: int, case: str, world: int, out_dir: str, port: int):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        if case == "four":
            res = {**_pipeline(out_dir, rank), **_sharded_lm(rank),
                   **_sharded_decode(rank), **_sharded_grads(rank),
                   **_save(out_dir, rank)}
        else:
            res = _restore(out_dir, rank, world)
        np.savez(os.path.join(out_dir, f"{case}_{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, world, out_dir, port = sys.argv[1:5]
    torch.set_num_threads(1)
    mp.spawn(_rank, args=(case, int(world), out_dir, int(port)),
             nprocs=int(world), join=True)
