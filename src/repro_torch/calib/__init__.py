"""``repro_torch.calib`` — fit the analytical model to measured ground truth,
on a device (the port of ``repro.calib``).

Fits a whitelisted subset of :class:`~repro_torch.core.constants.
TechConstants` fields — plus per-metric multiplicative correction factors —
by gradient descent through autograd on the port's evaluation path
(``analyze_chiplet`` / ``evaluate_system``).  Lifecycle::

    measure -> fit -> preset -> search

* ``measurements`` — the :class:`Measurement` record and loaders for three
  sources: ``core.simulator.simulate_matmul`` sweeps, published
  Simba/NN-Baton baseline numbers (via ``core/baselines.py``), and a
  zamlet-style CSV/JSON synthesis-report format.
* ``fit`` — ``fit(measurements, free=..., device=...)``: log-space Adam
  minimizing squared log error, with per-metric relative-error reports
  before/after on a held-out split.  Also the CLI:
  ``python -m repro_torch.calib.fit``.
* ``preset`` — :class:`CalibratedTech` artifacts (content digest, source
  provenance, error report), saved as JSON and loadable by name through
  ``core.presets.tech_preset`` / ``Session(tech=...)``.
"""

from .fit import FitResult, error_report, fit, predict  # noqa: F401
from .measurements import (Measurement, baseline_measurements,  # noqa: F401
                           load_report, measurements_digest, simulator_sweep)
from .preset import CalibratedTech, load_calibrated  # noqa: F401

__all__ = [
    "CalibratedTech", "FitResult", "Measurement", "baseline_measurements",
    "error_report", "fit", "load_calibrated", "load_report",
    "measurements_digest", "predict", "simulator_sweep",
]
