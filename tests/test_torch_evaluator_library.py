"""The port's evaluator against the JAX reference on every graph of the
model-derived ``workload_library()`` (the transfer path's graphs): the
port's own library builds the same padded spec arrays as the reference's,
and a random population drawn by the reference goes through both
``make_batch_evaluator``s on the CPU — every ``METRIC_KEYS`` column and
``feasibility_penalty`` at rtol 1e-4 (see ``test_torch_evaluator.py``).

The card sums the network's link loads as a product of one-hot matrices
(``network.link_load_dense``) where the CPU scatter-adds; both forms are
held to each other here on routes through every topology table."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import numpy as np
import pytest
import torch

import repro.core as C
from test_torch_evaluator import population_parity

from repro_torch.core import presets as tp
from repro_torch.core.evaluate import SystemSpec
from repro_torch.core.network import (N_TOT, link_load_dense,
                                      next_hop_tensor, route_links)


@pytest.mark.parametrize("name", sorted(C.presets.workload_library()))
def test_random_population_workload_library(name):
    ref_graph = C.presets.workload_library()[name]
    ref_spec = C.SystemSpec.build(ref_graph, ch_max=2)
    spec = SystemSpec.build(tp.workload_library()[name], ch_max=2)
    assert (spec.W, spec.CH, spec.E) == (ref_spec.W, ref_spec.CH, ref_spec.E)
    for k, v in ref_spec.arrays.items():
        np.testing.assert_array_equal(spec.arrays[k], np.asarray(v),
                                      err_msg=k)
    population_parity(ref_graph, ch_max=2, seed=11)


@pytest.mark.parametrize("seed", range(3))
def test_dense_link_load_matches_scatter(seed):
    """Integer requirements sum exactly in any order, so the one-hot
    product must equal ``scatter_add_`` bit for bit; source ids past the
    table (their first hop is no link) are dropped by both."""
    g = torch.Generator().manual_seed(seed)
    P, Fl = 24, 40
    nh_all = next_hop_tensor("cpu")
    nh = nh_all[torch.randint(0, nh_all.shape[0], (P,), generator=g)]
    src = torch.randint(0, N_TOT + 4, (P, Fl), generator=g)
    dst = torch.randint(0, N_TOT, (P, Fl), generator=g)
    u, v, _ = route_links(nh, src, dst)
    lid = u * N_TOT + v
    bwr = torch.randint(1, 1 << 12, (P, Fl), generator=g).float()
    w = torch.where((u != v) & (lid < N_TOT * N_TOT), bwr[None], 0.0)
    H = u.shape[0]
    want = torch.zeros(P, N_TOT * N_TOT).scatter_add_(
        1, torch.where(lid < N_TOT * N_TOT, lid, 0).permute(1, 0, 2)
        .reshape(P, H * Fl), w.permute(1, 0, 2).reshape(P, H * Fl))
    got = link_load_dense(u, v, w)
    assert want.sum() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
