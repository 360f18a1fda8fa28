"""``repro_torch.core`` — the Monad analytical model over tensors with a
population dimension: workload IR, dataflow/network/energy/cost models, the
system evaluator, the design-space encoding, the BO x SA engine and the
Simba / NN-Baton baselines (ports of ``repro.core``)."""

from . import constants, presets, workload  # noqa: F401
from .constants import DEFAULT_TECH, TechConstants  # noqa: F401
from .encoding import (ALL_FIELDS, ARCH_FIELDS, BO_FIELDS,  # noqa: F401
                       INTEG_FIELDS, SA_FIELDS, DesignSpace,
                       feasibility_penalty, mutate, random_design)
from .evaluate import (SystemSpec, evaluate_arrays,  # noqa: F401
                       evaluate_system, make_batch_evaluator, spec_tensors)
from .optimizer import (METRIC_KEYS, OBJ_COST_EDP, OBJ_EDP,  # noqa: F401
                        OBJ_ENERGY, OBJ_LATENCY, SAConfig, SearchResult,
                        log_metric_stack, make_sa, metric_stack,
                        pareto_front)
from .baselines import Baseline, make_baseline  # noqa: F401
