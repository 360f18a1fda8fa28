"""Fault-tolerant training driver: checkpoint/restart, step retry and
straggler monitoring (the reference's ``repro/runtime/driver.py``).

``FaultTolerantTrainer.run`` owns the loop:
  * restores from the newest COMMITTED checkpoint (torn saves are skipped),
  * saves every ``ckpt_every`` steps through the async CheckpointManager,
    and the last step when the run ends,
  * retries a step on a ``TransientError``, first restoring the state from
    the last checkpoint (a train step updates its state in place, so a
    step that failed part way may have left it half updated),
  * feeds per-step wall times to the StragglerMonitor; flagged steps are
    reported to the caller.

The train step is called as given (``launch.train.make_train_step``); a
step's loss is read back to the host once a step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from ..checkpoint.manager import CheckpointManager
from .straggler import StragglerMonitor


@dataclasses.dataclass
class RunReport:
    start_step: int
    end_step: int
    losses: List[float]
    restarts: int
    straggler_steps: List[int]
    wall_s: float


class TransientError(RuntimeError):
    """Raised by fault-injection hooks / wrapped device errors."""


class FaultTolerantTrainer:
    def __init__(self, train_step: Callable, ckpt: CheckpointManager,
                 ckpt_every: int = 50, max_retries: int = 3,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.train_step = train_step
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.fault_hook = fault_hook
        self.monitor = StragglerMonitor()

    def run(self, state, batch_at: Callable[[int], Dict],
            num_steps: int, start_step: Optional[int] = None) -> tuple:
        restarts = 0
        latest = self.ckpt.latest_step()
        step = start_step if start_step is not None else (
            (latest + 1) if latest is not None else 0)
        if latest is not None and start_step is None:
            state = self.ckpt.restore(latest, state)
        losses: List[float] = []
        stragglers: List[int] = []
        t0 = time.time()
        end = step + num_steps

        while step < end:
            t_step = time.time()
            tries = 0
            while True:
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    state, metrics = self.train_step(state, batch_at(step))
                    break
                except TransientError:
                    tries += 1
                    restarts += 1
                    if tries > self.max_retries:
                        raise
                    # recover: reload the last durable state and retry the
                    # same step
                    self.ckpt.wait()
                    latest = self.ckpt.latest_step()
                    if latest is not None:
                        state = self.ckpt.restore(latest, state)
            losses.append(float(metrics["loss"]))
            if self.monitor.observe(step, time.time() - t_step):
                stragglers.append(step)
            if self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step, state)
            step += 1

        self.ckpt.save(step - 1, state, blocking=True)
        return RunReport(start_step=end - num_steps, end_step=step,
                         losses=losses, restarts=restarts,
                         straggler_steps=stragglers,
                         wall_s=time.time() - t0), state
