"""Shared pow2 quantization for segment planning and megabatch bucketing.

One home for the "round everything to powers of two" machinery that used
to live as private helpers inside ``service.py`` (and was duplicated in
``api._plan_impl``).  Two layers use it:

* **segment planning** — a query budget is quantized into a
  ``(pop, generations, chunk, n_seg)`` schedule so every NSGA scan the
  service ever compiles comes from a small lattice of shapes, and the
  jit cache is shared across wildly different budgets;
* **megabatch bucketing** — distinct problems fuse into one compiled
  dispatch only when their compile-relevant statics coincide; the lane
  count of a fused dispatch is pow2-padded so the vmapped-run cache is
  keyed on the same small lattice.

Everything here is pure host-side integer math — no JAX imports — so it
can be called from planning code before any device work is traced.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "pow2_ceil", "pow2_floor", "effective_pop", "Schedule", "schedule",
]

MIN_POP = 8     # population floor: below this, tournament selection and
#                 crowding distance degenerate


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << max(0, int(n).bit_length() - 1)


def effective_pop(budget: int, pop_ceiling: int,
                  quantize_down: bool = False) -> int:
    """The population width a refinement will actually run for one
    budget: sub-ceiling budgets shrink the population (pow2 ceil
    normally, pow2 floor when the budget is a hard cap; floored at
    ``MIN_POP``)."""
    pop = pop_ceiling
    if budget < pop:
        p = pow2_ceil(budget)
        if quantize_down and p > budget:
            p >>= 1
        pop = min(pop, max(MIN_POP, p))
    return pop


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One quantized refinement schedule: ``generations`` total, run as
    ``n_seg`` segments of ``chunk`` generations each over a ``pop``-wide
    population (all powers of two; ``n_seg * chunk == generations``)."""
    pop: int
    generations: int
    chunk: int
    n_seg: int

    @property
    def evals(self) -> int:
        return self.pop * self.generations


def schedule(budget: int, pop_ceiling: int, chunk_generations: int,
             quantize_down: bool = False) -> Schedule:
    """Quantize a raw evaluation budget into the pow2 lattice schedule
    the service executes.  ``quantize_down`` floors instead of ceils the
    generation quantization, guaranteeing the run never spends more than
    ``budget`` — used when spending ledger credit, which must not be
    exceeded."""
    pop = effective_pop(budget, pop_ceiling, quantize_down)
    if quantize_down:           # largest pow2 <= budget/pop, floored at 1
        generations = 1 << max(0, (budget // pop).bit_length() - 1)
    else:
        generations = pow2_ceil(-(-budget // pop))      # ceil, then pow2
    chunk = min(pow2_ceil(chunk_generations), generations)
    return Schedule(pop=pop, generations=generations, chunk=chunk,
                    n_seg=generations // chunk)         # pow2 => divides


def bucket_lanes(n: int, max_lanes: Optional[int] = None) -> int:
    """Padded lane count for a fused megabatch dispatch: pow2 ceil,
    optionally clamped to ``max_lanes`` (itself expected to be pow2)."""
    lanes = pow2_ceil(n)
    if max_lanes is not None:
        lanes = min(lanes, pow2_ceil(max_lanes))
    return lanes
