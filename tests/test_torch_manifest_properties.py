"""Property-based tests (hypothesis) for the port's manifest growth policy,
as the reference's ``tests/test_manifest_properties.py`` has them: LRU
eviction never removes the entry being written or queried, dedup is
idempotent and commutative, and ``nearest()`` is invariant under
entry-insertion order.  Each property also holds the port's manifest to
the reference's ``ArchiveManifest`` fed the same entries (entry sets,
counters, and ``nearest`` at 1e-12)."""

import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.explore import archive as ref_arc  # noqa: E402

from repro_torch.explore.archive import (ArchiveManifest,  # noqa: E402
                                         ManifestPolicy)

DIM = 4

coords = st.lists(st.integers(0, 6), min_size=DIM, max_size=DIM)
entry_lists = st.lists(
    st.tuples(coords, st.integers(0, 64)),     # (embedding, n_evals)
    min_size=1, max_size=12)


def _manifest(policy, items, key=lambda i: f"k{i}", mod=None):
    m = (ArchiveManifest(policy=ManifestPolicy(**policy)) if mod is None
         else mod.ArchiveManifest(policy=mod.ManifestPolicy(**policy)))
    for i, (emb, n_evals) in enumerate(items):
        m.update(key(i), np.asarray(emb, np.float64), (1, 2, 1),
                 n_evals, n_evals, ("latency_ns",), digest={"i": i})
    return m


def _same_entries(a, b):
    assert set(a.entries) == set(b.entries)
    for k in a.entries:
        for f in ("n_evals", "budget_covered", "searched", "last_used"):
            assert a.entries[k][f] == b.entries[k][f]
        np.testing.assert_array_equal(a.entries[k]["embedding"],
                                      b.entries[k]["embedding"])


@settings(max_examples=50, deadline=None)
@given(items=entry_lists, max_entries=st.integers(1, 6))
def test_eviction_never_removes_the_entry_being_written(items, max_entries):
    m = ArchiveManifest(policy=ManifestPolicy(max_entries=max_entries))
    for i, (emb, n_evals) in enumerate(items):
        k = f"k{i}"
        m.update(k, np.asarray(emb, np.float64), (1, 2, 1),
                 n_evals, n_evals, (), digest={})
        assert k in m.entries
        assert len(m.entries) <= max_entries
    ref = ref_arc.ArchiveManifest(
        policy=ref_arc.ManifestPolicy(max_entries=max_entries))
    for i, (emb, n_evals) in enumerate(items):
        ref.update(f"k{i}", np.asarray(emb, np.float64), (1, 2, 1),
                   n_evals, n_evals, (), digest={})
    _same_entries(m, ref)


@settings(max_examples=50, deadline=None)
@given(items=entry_lists, max_entries=st.integers(1, 6),
       qi=st.integers(0, 11))
def test_eviction_never_removes_the_entry_being_queried(items, max_entries,
                                                        qi):
    pol = dict(max_entries=len(items) + 1)
    m = _manifest(pol, items)
    ref = _manifest(pol, items, mod=ref_arc)
    qk = f"k{qi % len(items)}"
    before = set(m.entries)
    m.nearest(m.entries[qk]["embedding"], k=3)
    assert set(m.entries) == before            # queries evict nothing
    m.policy = ManifestPolicy(max_entries=max_entries)
    m.enforce(protect=(qk,))
    assert qk in m.entries
    assert len(m.entries) <= max(max_entries, 1)
    ref.policy = ref_arc.ManifestPolicy(max_entries=max_entries)
    ref.enforce(protect=(qk,))
    _same_entries(m, ref)


@settings(max_examples=50, deadline=None)
@given(items=entry_lists, radius=st.floats(0.0, 2.0))
def test_dedup_is_idempotent(items, radius):
    pol = dict(max_entries=64, dedup_radius=radius)
    m = _manifest(pol, items)
    _same_entries(m, _manifest(pol, items, mod=ref_arc))
    once = {k: dict(e, embedding=e["embedding"].copy())
            for k, e in m.entries.items()}
    m.dedup()
    for k in m.entries:
        assert k in once
        for f in ("n_evals", "budget_covered", "searched", "last_used"):
            assert m.entries[k][f] == once[k][f]
        np.testing.assert_array_equal(m.entries[k]["embedding"],
                                      once[k]["embedding"])


@settings(max_examples=50, deadline=None)
@given(a=coords, b=coords, na=st.integers(0, 64), nb=st.integers(0, 64),
       radius=st.floats(0.1, 3.0))
def test_dedup_merge_is_commutative(a, b, na, nb, radius):
    pol0 = dict(max_entries=64, dedup_radius=0.0)
    m1 = _manifest(pol0, [(a, na), (b, nb)])
    m2 = _manifest(pol0, [(b, nb), (a, na)], key=lambda i: f"k{1 - i}")
    ref = _manifest(pol0, [(a, na), (b, nb)], mod=ref_arc)
    for m in (m1, m2):
        m.policy = ManifestPolicy(max_entries=64, dedup_radius=radius)
        m.dedup()
    ref.policy = ref_arc.ManifestPolicy(max_entries=64, dedup_radius=radius)
    ref.dedup()
    assert set(m1.entries) == set(m2.entries) == set(ref.entries)
    for k in m1.entries:
        assert m1.entries[k]["n_evals"] == m2.entries[k]["n_evals"] \
            == ref.entries[k]["n_evals"]
        assert m1.entries[k]["budget_covered"] \
            == m2.entries[k]["budget_covered"]
        np.testing.assert_array_equal(m1.entries[k]["embedding"],
                                      m2.entries[k]["embedding"])


@settings(max_examples=50, deadline=None)
@given(items=entry_lists, q=coords, k=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1))
def test_nearest_is_invariant_under_entry_reordering(items, q, k, seed):
    pol = dict(max_entries=64)
    m1 = _manifest(pol, items)
    order = np.random.default_rng(seed).permutation(len(items))
    m2 = ArchiveManifest(policy=ManifestPolicy(**pol))
    for i in order:
        emb, n_evals = items[i]
        m2.update(f"k{i}", np.asarray(emb, np.float64), (1, 2, 1),
                  n_evals, n_evals, ("latency_ns",), digest={"i": int(i)})
    qv = np.asarray(q, np.float64)
    got1, got2 = m1.nearest(qv, k=k), m2.nearest(qv, k=k)
    want = _manifest(pol, items, mod=ref_arc).nearest(qv, k=k)
    assert [kk for kk, _ in got1] == [kk for kk, _ in got2] \
        == [kk for kk, _ in want]
    np.testing.assert_allclose([d for _, d in got1], [d for _, d in got2])
    np.testing.assert_allclose([d for _, d in got1], [d for _, d in want],
                               rtol=1e-12, atol=1e-12)
