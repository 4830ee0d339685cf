"""Recovery policies: retry schedules and degradation ladders (§12).

Port of ``src/repro/fault/policy.py``, a copy apart from its
imports, held against it by ``tests/test_torch_fault.py`` and
``tests/test_torch_fault_fuzz.py``.

One :class:`FaultPolicy` object parameterizes every recovery mechanism in
the stack:

  * transient transfer errors — per-op retry with exponential backoff
    (:meth:`backoff` / :meth:`backoff_schedule`; ``sleep`` is injectable
    so tests pin the schedule against a fake clock);
  * compute faults — block-granular replay, bounded by ``max_retries``
    attempts per op just like transfers;
  * oom — the :meth:`degrade_ladder` walked by the entry points
    (``ooc_cholesky`` / ``ooc_lu`` / ``ooc_gemm``): halve nbuf, drop
    lookahead, then halve the memory budget and recompile through the
    existing planning paths.  Every attempted step is recorded in
    ``degrades`` so tests (and users) can see exactly how the run was
    degraded.

:meth:`fault_model` bridges to the simulator's faulted-makespan mode so
the tuner can rank plans by expected cost under this policy's backoff
constants (``simulate(sched, hw, faults=policy.fault_model(rate))``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List


@dataclasses.dataclass(frozen=True)
class DegradeStep:
    """One rung of the oom ladder: the knob turned and the resulting
    plan-input triple to recompile with."""

    action: str          # "halve_nbuf" | "drop_lookahead" | "halve_budget"
    nbuf: int
    lookahead: int
    budget_bytes: int


@dataclasses.dataclass
class FaultPolicy:
    """Recovery parameters threaded through executor and entry points."""

    max_retries: int = 3
    backoff_base: float = 0.01
    backoff_factor: float = 2.0
    max_budget_halvings: int = 2
    sleep: Callable[[float], None] = time.sleep
    # attempted degrade steps, appended by the entry points' oom handlers
    degrades: List[DegradeStep] = dataclasses.field(default_factory=list)

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based): base * factor^(a-1)."""
        return self.backoff_base * self.backoff_factor ** (attempt - 1)

    def backoff_schedule(self) -> List[float]:
        """The full pinned delay sequence a fully-retried op sleeps."""
        return [self.backoff(a) for a in range(1, self.max_retries + 1)]

    def degrade_ladder(self, *, nbuf: int, lookahead: int,
                       budget_bytes: int,
                       tuned: bool = False) -> List[DegradeStep]:
        """Successive recompile attempts after an oom, cheapest knob first.

        Untuned: halve nbuf (if > 1), drop lookahead (if > 0), then halve
        the budget up to ``max_budget_halvings`` times.  Tuned: the tuner
        owns nbuf/lookahead, so the ladder is budget halvings only — each
        rung re-searches at the reduced budget, which is what makes the
        degraded run land on exactly the plan the tuner would pick there.
        """
        steps: List[DegradeStep] = []
        nb, la, b = nbuf, lookahead, budget_bytes
        if not tuned:
            if nb > 1:
                nb = max(1, nb // 2)
                steps.append(DegradeStep("halve_nbuf", nb, la, b))
            if la > 0:
                la = 0
                steps.append(DegradeStep("drop_lookahead", nb, la, b))
        for _ in range(self.max_budget_halvings):
            b //= 2
            if b <= 0:
                break
            steps.append(DegradeStep("halve_budget", nb, la, b))
        return steps

    def fault_model(self, rate: float):
        """Simulator :class:`~repro_torch.core.simulator.FaultModel` under this
        policy's backoff constants, for expected-makespan ranking."""
        from repro_torch.core.simulator import FaultModel

        return FaultModel(rate=rate, mean_backoff=self.backoff_base)
