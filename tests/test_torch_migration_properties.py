"""Property-based tests (hypothesis) for the port's portable design IR, as
the reference's ``tests/test_migration_properties.py`` has them: migration
round-trips exactly through superset spec spaces, migrated and repaired
designs are always feasible under the destination bounds, and ``repair``
is idempotent and digest-equivalent — for arbitrary source designs and
(source, destination) pairs from the model-derived workload library.
Every migrated or repaired design is also held to the reference's
(``repro.core.encoding``) on the same numpy input, exactly."""

import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import DesignSpace as RefSpace  # noqa: E402
from repro.core import SystemSpec as RefSpec  # noqa: E402
from repro.core import encoding as ref_enc  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro.core import workload as ref_wl  # noqa: E402

from repro_torch.core import presets as P  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.encoding import (DesignSpace, migrate,  # noqa: E402
                                       random_design, repair, space_digest)
from repro_torch.core.evaluate import SystemSpec  # noqa: E402

from test_torch_transfer import (assert_design_feasible,  # noqa: E402
                                 assert_same_design)

seeds = st.integers(0, 2**31 - 1)
dims = st.integers(8, 512)


def _pool(presets_mod, mod):
    lib = presets_mod.workload_library()
    return [lib["attn_qwen2_72b"], lib["attn_qwen2_5_32b"],
            lib["mlp_qwen2_72b"], lib["conv_whisper"],
            lib["scan_falcon_mamba"], lib["hybrid_hymba"],
            presets_mod.transformer_block(),
            mod.WorkloadGraph([mod.matmul("mm", 256, 256, 64)], [])]


_POOL, _REF_POOL = _pool(P, W), _pool(ref_presets, ref_wl)
_SPACES = {}


def _space(gi, ch_max):
    """(port space, reference space) of pool graph ``gi``."""
    if (gi, ch_max) not in _SPACES:
        _SPACES[gi, ch_max] = (
            DesignSpace(SystemSpec.build(_POOL[gi], ch_max=ch_max)),
            RefSpace(RefSpec.build(_REF_POOL[gi], ch_max=ch_max)))
    return _SPACES[gi, ch_max]


def _raw(space, seed):
    return {k: v.numpy() for k, v in
            random_design(seed, space, device="cpu").items()}


@settings(max_examples=20, deadline=None)
@given(seed=seeds, m=dims, n=dims, k=dims, extra=st.integers(0, 2),
       ch_add=st.integers(0, 2))
def test_migrate_roundtrips_through_larger_space(seed, m, n, k, extra,
                                                 ch_add):
    def graphs(mod):
        gA = mod.WorkloadGraph([mod.matmul("mm", m, n, k)], [])
        gB = mod.WorkloadGraph(list(gA.workloads) + [
            mod.matmul(f"x{i}", 64 + 32 * i, 64, 64) for i in range(extra)],
            [])
        return gA, gB
    gA, gB = graphs(W)
    spA = DesignSpace(SystemSpec.build(gA, ch_max=2))
    spB = DesignSpace(SystemSpec.build(gB, ch_max=2 + ch_add))
    dA = repair(_raw(spA, seed), spA)
    dB = migrate(dA, spA, spB)
    assert_design_feasible(dB, spB)
    assert_same_design(migrate(dB, spB, spA), dA)
    rA, rB = graphs(ref_wl)
    assert_same_design(dB, ref_enc.migrate(
        dA, RefSpace(RefSpec.build(rA, ch_max=2)),
        RefSpace(RefSpec.build(rB, ch_max=2 + ch_add))))


@settings(max_examples=20, deadline=None)
@given(seed=seeds, src=st.integers(0, len(_POOL) - 1),
       dst=st.integers(0, len(_POOL) - 1),
       ch_src=st.integers(1, 3), ch_dst=st.integers(1, 3))
def test_migrated_designs_always_feasible(seed, src, dst, ch_src, ch_dst):
    src_space, ref_src = _space(src, ch_src)
    dst_space, ref_dst = _space(dst, ch_dst)
    d = repair(_raw(src_space, seed), src_space)
    out = migrate(d, src_space, dst_space)
    assert_design_feasible(out, dst_space)
    assert_same_design(out, ref_enc.migrate(d, ref_src, ref_dst))


@settings(max_examples=20, deadline=None)
@given(seed=seeds, gi=st.integers(0, len(_POOL) - 1))
def test_repair_is_idempotent_and_digest_equivalent(seed, gi):
    space, ref_space = _space(gi, 2)
    raw = _raw(space, seed)
    d1 = repair(raw, space)
    assert_same_design(repair(d1, space), d1)
    assert_same_design(repair(raw, space_digest(space).to_json_dict()), d1)
    assert_same_design(ref_enc.repair(raw, ref_space), d1)
