"""``repro_torch.core`` — the Monad analytical model over tensors with a
population dimension: workload IR, dataflow/network/energy/cost models, the
system evaluator and the design-space encoding (ports of ``repro.core``)."""

from . import constants, presets, workload  # noqa: F401
from .constants import DEFAULT_TECH, TechConstants  # noqa: F401
from .encoding import (ALL_FIELDS, DesignSpace,  # noqa: F401
                       feasibility_penalty, mutate, random_design)
from .evaluate import (SystemSpec, evaluate_arrays,  # noqa: F401
                       evaluate_system, make_batch_evaluator, spec_tensors)
from .optimizer import METRIC_KEYS, log_metric_stack, metric_stack  # noqa: F401
