"""The port's evaluator against the JAX reference on the paper's Fig. 7
suite (ResNet-50 convolutions + BERT-large matmuls): random populations
drawn by the reference, every ``METRIC_KEYS`` column and
``feasibility_penalty`` at rtol 1e-4 (see ``test_torch_evaluator.py``)."""

import jax  # noqa: F401  (the reference runs on the CPU here)
import pytest

import repro.core as C
from test_torch_evaluator import population_parity


@pytest.mark.parametrize("name", sorted(C.presets.fig7_suite()))
def test_random_population_fig7(name):
    population_parity(C.presets.fig7_suite()[name], ch_max=8, seed=7)
