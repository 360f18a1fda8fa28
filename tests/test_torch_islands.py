"""Island-model NSGA in the port (``make_nsga(mesh=)``, the service's and
the session's ``mesh=``) against the reference's island model
(``repro.explore.nsga`` under ``shard_map``, the cases of
``tests/test_scale.py``):

* a 1-island mesh is the plain run, bit for bit;
* 4 islands split over two or four devices give the bits of the same
  islands on one device;
* the reference's validation errors;
* ``_mesh_for`` falls back to the plain loop as the reference's does;
* migration: after a migration generation island i's worst tail is island
  i - 1's elite head, and nothing else differs from a run without
  migration; before it nothing differs at all;
* the island count is in the checkpoint signature, and ``Plan.islands``
  follows ``_mesh_for``;
* the statistical gate: pooled over fixed seeds, the port's 4-island
  front hypervolume at pop 16 and budget 256 (the session NSGA gate's
  problem) is at least 0.99 x the reference's 4-island run, which runs
  in one subprocess with 4 forced host devices for all seeds.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.api import Problem, Query, Session
from repro_torch.core import presets as tp
from repro_torch.core.encoding import DesignSpace, random_design
from repro_torch.core.evaluate import SystemSpec
from repro_torch.explore.archive import HV_LOG_REF, hypervolume_2d
from repro_torch.explore.nsga import ISLAND_AXIS, NSGAConfig, make_nsga
from repro_torch.explore.service import ExplorationService
from repro_torch.launch.mesh import IslandMesh, make_island_mesh

OBJ = ("latency_ns", "cost_usd")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(pop=16):
    spec = SystemSpec.build(tp.transformer_block(), ch_max=4)
    space = DesignSpace(spec)
    return spec, space, random_design(0, space, n=pop, device="cpu")


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), k
        else:
            assert torch.equal(x, y)


def test_one_island_is_the_plain_run():
    spec, space, pop0 = _setup()
    cfg = NSGAConfig(pop=16, generations=5)
    plain = make_nsga(spec, space, OBJ, cfg, device="cpu")(3, pop0)
    isl = make_nsga(spec, space, OBJ, cfg, device="cpu",
                    mesh=make_island_mesh(1, ("cpu",)))(3, pop0)
    _assert_same(plain, isl)


def test_islands_split_over_devices_equal_one_device():
    spec, space, pop0 = _setup(pop=32)
    cfg = NSGAConfig(pop=32, generations=5, migration_interval=2,
                     migration_frac=0.25)
    one = make_nsga(spec, space, OBJ, cfg,
                    mesh=make_island_mesh(4, ("cpu",)))(5, pop0)
    for devices in (("cpu", "cpu"), ("cpu",) * 4):
        mesh = make_island_mesh(4, devices)
        assert len(mesh.blocks()) == len(devices)
        _assert_same(one, make_nsga(spec, space, OBJ, cfg, mesh=mesh)(5,
                                                                      pop0))
    pop, raw, sel, ev_d, ev_raw, ev_feas, tr = one
    assert raw.shape == (32, 4) and sel.shape == (32, 2)
    assert ev_raw.shape == (5, 32, 4) and ev_feas.shape == (5, 32)
    assert tr["front_size"].shape == (5,) and tr["hypervolume"].shape == (5, 1)
    assert np.all(np.diff(tr["hypervolume"][:, 0].numpy()) >= 0)


class _Stand:
    def __init__(self, **shape):
        self.shape = shape


def test_island_mesh_validation():
    spec, space, _ = _setup()
    with pytest.raises(ValueError, match=ISLAND_AXIS):
        make_nsga(spec, space, OBJ, NSGAConfig(pop=8, generations=2),
                  mesh=_Stand(wrong=1))
    with pytest.raises(ValueError, match="cannot shard"):
        make_nsga(spec, space, OBJ, NSGAConfig(pop=10, generations=2),
                  mesh=make_island_mesh(4, ("cpu",)))
    with pytest.raises(ValueError, match="cannot shard"):
        make_nsga(spec, space, OBJ, NSGAConfig(pop=4, generations=2),
                  mesh=make_island_mesh(4, ("cpu",)))
    if not torch.cuda.is_available():      # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_island_mesh(2)


def test_service_mesh_for_degrades_unshardable_pops(tmp_path):
    svc = ExplorationService(cache_dir=tmp_path, device="cpu",
                             mesh=make_island_mesh(1, ("cpu",)))
    assert svc._mesh_for(8) is svc.mesh     # 1 island always fits
    svc.mesh = _Stand(islands=4)
    assert svc._mesh_for(8) is svc.mesh     # 4 islands of 2
    assert svc._mesh_for(9) is None         # not divisible
    assert svc._mesh_for(4) is None         # islands of 1 degenerate
    svc.mesh = None
    assert svc._mesh_for(8) is None


def test_migration_moves_elite_heads_around_the_ring():
    """pop 64 on 4 islands of 16: 2 migrants every 4th generation.  A run
    without migration (``migration_frac=0``) draws the same numbers, so
    it is the migrating run's state before each migration."""
    spec, space, pop0 = _setup(pop=64)
    n, N, m = 4, 16, 2
    mesh = make_island_mesh(n, ("cpu", "cpu"))

    def run(G, frac):
        cfg = NSGAConfig(pop=64, generations=G, migration_interval=4,
                         migration_frac=frac)
        return make_nsga(spec, space, OBJ, cfg, mesh=mesh)(11, pop0)
    # generations 0-2 migrate nothing
    _assert_same(run(3, 0.125), run(3, 0.0))
    mig, stay = run(4, 0.125), run(4, 0.0)
    tail = np.zeros(n * N, bool)
    for i in range(n):
        tail[i * N + N - m:(i + 1) * N] = True
    for a, b in [(mig[0][k], stay[0][k]) for k in mig[0]] + [
            (mig[1], stay[1]), (mig[2], stay[2])]:
        assert torch.equal(a[~torch.as_tensor(tail)],
                           b[~torch.as_tensor(tail)])
        for i in range(n):
            j = (i - 1) % n
            assert torch.equal(a[i * N + N - m:(i + 1) * N],
                               b[j * N:j * N + m])
    # the candidates of the migration generation are the same; the
    # telemetry sees the migrated population
    _assert_same(mig[3:6], stay[3:6])
    assert not torch.equal(mig[1], stay[1])


def test_island_count_in_signature_and_plan(tmp_path):
    svc = ExplorationService(cache_dir=tmp_path, device="cpu",
                             nsga=NSGAConfig(pop=16))
    args = (OBJ, 256, 16, 16, 4, 0, None)
    plain = svc._ckpt_signature(*args)
    svc.mesh = make_island_mesh(1, ("cpu",))
    assert svc._ckpt_signature(*args) == plain
    svc.mesh = make_island_mesh(4, ("cpu",))
    four = svc._ckpt_signature(*args)
    assert four != plain
    svc.mesh = make_island_mesh(2, ("cpu",))
    assert svc._ckpt_signature(*args) not in (plain, four)
    # the islands' device type signs the run, not the service's: a split
    # over two CPU blocks draws the same streams, islands on the card not
    svc.mesh = make_island_mesh(4, ("cpu", "cpu"))
    assert svc._ckpt_signature(*args) == four
    svc.mesh = IslandMesh(4, (torch.device("cuda"),))
    assert svc._ckpt_signature(*args) not in (plain, four)
    p = Problem(tp.bert_mms()["att2"], OBJ, ch_max=4)
    s = Session(cache_dir=tmp_path / "s", device="cpu",
                nsga=NSGAConfig(pop=16), mesh=make_island_mesh(4, ("cpu",)))
    assert s.plan(Query(p, budget=256)).islands == 4
    assert s.clone().service.mesh == s.service.mesh
    s8 = Session(cache_dir=tmp_path / "s8", device="cpu",
                 nsga=NSGAConfig(pop=16), mesh=make_island_mesh(3, ("cpu",)))
    assert s8.plan(Query(p, budget=256)).islands == 1   # 16 % 3 != 0


# the gate: pop 16, budget 256 (the session gate's problem), 4 islands.
# One seed's hypervolume spreads ~25-35 around ~1135 in each package, so
# the pooled ratio's standard error is ~3.5% / sqrt(seeds): ~1.4% at 6
# seeds, too coarse for a 1% gate, ~0.64% at 30.  Seeds 30-59 read a
# pooled ratio of 1.0009, seeds 0-29 1.0070
HV_GATE = 0.99
HV_SEEDS = tuple(range(30))

_REF = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    import repro.api as ref_api, repro.core as C
    from jax.sharding import Mesh
    from repro.explore.nsga import NSGAConfig
    from repro.explore.archive import HV_LOG_REF, hypervolume_2d
    mesh = Mesh(np.array(jax.devices()[:4]), ("islands",))
    out = []
    for s in json.loads(sys.argv[2]):
        ses = ref_api.Session(cache_dir=f"{sys.argv[1]}/ref{s}",
                              nsga=NSGAConfig(pop=16), mesh=mesh)
        q = ref_api.Query(ref_api.Problem(C.presets.bert_mms()["att2"],
                                          ("latency_ns", "cost_usd"),
                                          ch_max=4),
                          budget=256, engine="nsga")
        r = ses.submit(q, key=jax.random.PRNGKey(s))
        assert r.provenance.n_evals_run == 256
        f = np.log(np.maximum(np.asarray(r.front_objs), 1e-3))
        out.append(float(hypervolume_2d(f, (HV_LOG_REF, HV_LOG_REF))))
    print(json.dumps(out))
""")


def hypervolumes(seeds, tmp) -> tuple:
    """(port, reference) front hypervolumes of the gate's 4-island query at
    each of ``seeds``: the reference's in one subprocess with 4 forced
    host devices, running while the port's run here."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp), json.dumps(list(seeds))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port_hv = []
    for s in seeds:
        ses = Session(cache_dir=os.path.join(tmp, f"port{s}"), device="cpu",
                      nsga=NSGAConfig(pop=16),
                      mesh=make_island_mesh(4, ("cpu",)))
        r = ses.submit(Query(Problem(tp.bert_mms()["att2"], OBJ, ch_max=4),
                             budget=256), key=s)
        assert r.provenance.n_evals_run == 256
        f = np.log(np.maximum(np.asarray(r.front_objs), 1e-3))
        port_hv.append(float(hypervolume_2d(f, (HV_LOG_REF, HV_LOG_REF))))
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return port_hv, json.loads(out.strip().splitlines()[-1])


def test_four_island_hypervolume_gate_against_reference(tmp_path):
    port_hv, ref_hv = hypervolumes(HV_SEEDS, tmp_path)
    ratio = np.mean(port_hv) / np.mean(ref_hv)
    print(f"4-island gate: pooled ratio {ratio:.6f} (gate {HV_GATE})")
    assert ratio >= HV_GATE, (port_hv, ref_hv)


if __name__ == "__main__":
    # per-seed readings of both packages over seeds [first, last), e.g.
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_islands.py 30 60
    import tempfile
    seeds = range(int(sys.argv[1]), int(sys.argv[2]))
    with tempfile.TemporaryDirectory() as tmp:
        port_hv, ref_hv = hypervolumes(seeds, tmp)
    for s, a, b in zip(seeds, port_hv, ref_hv):
        print(f"seed {s}: port {a:.6f} reference {b:.6f}")
    print(json.dumps(dict(
        seeds=[seeds.start, seeds.stop],
        ratio=float(np.mean(port_hv) / np.mean(ref_hv)),
        port_mean=float(np.mean(port_hv)),
        port_sd=float(np.std(port_hv, ddof=1)),
        ref_mean=float(np.mean(ref_hv)),
        ref_sd=float(np.std(ref_hv, ddof=1)))))
