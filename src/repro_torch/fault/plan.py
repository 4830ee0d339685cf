"""Deterministic, schedule-addressable fault plans (DESIGN.md §12).

Port of ``src/repro/fault/plan.py``, a copy apart from its
imports, held against it by ``tests/test_torch_fault.py`` and
``tests/test_torch_fault_fuzz.py``.

A :class:`FaultPlan` is a seeded, replayable list of :class:`FaultSpec`
entries addressed the same way the schedule itself is addressed: by op
index in global issue order (optionally pinned to a stream as a
cross-check).  ``FaultPlan.random(seed, sched, rate)`` draws a Bernoulli
plan over the schedule's *eligible* ops, so the conformance fuzzer can
generate thousands of distinct fault scenarios that are each exactly
reproducible from ``(seed, schedule)``.

Eligibility is deliberately conservative: transfer faults target H2D ops
and slice write-backs (both idempotent), compute faults target only the
replayable single-writer kernels (``REPLAYABLE_KERNELS``).  Finalize
handlers such as ``lu_writeback`` mutate host state irreversibly
(row-swap replay on the host matrix) and are never injected.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.streams import BlockRef, Op, OpKind, Schedule
from repro_torch.fault.errors import ERROR_CLASSES

# Compute kernels whose faults the executor can recover by block-granular
# replay: exactly one written parity buffer, no irreversible host or
# scratch mutation (``panel_lu`` re-parks its pivots on replay, which is
# idempotent because ``lu_writeback`` pops them only at finalize time).
REPLAYABLE_KERNELS = frozenset(
    {"dgemm", "panel_chol", "panel_trsm", "panel_lu", "lu_trsm"})


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One addressed fault: fail op ``op`` with error class ``cls``.

    ``times`` faults that many consecutive *attempts* of the op (times=2
    against a retry policy means: first try faults, first retry faults,
    second retry succeeds).  ``stream``/``device`` are optional pins the
    injector cross-checks against the op actually executing — a mismatch
    is a plan-authoring error and raises, it does not silently no-op.
    """

    op: int
    cls: str
    times: int = 1
    stream: Optional[int] = None
    device: Optional[str] = None

    def __post_init__(self):
        if self.cls not in ERROR_CLASSES:
            raise ValueError(
                f"unknown fault class {self.cls!r}; expected one of "
                f"{sorted(ERROR_CLASSES)}")
        if self.op < 0:
            raise ValueError(f"fault op index must be >= 0, got {self.op}")
        if self.times < 1:
            raise ValueError(f"fault times must be >= 1, got {self.times}")


def _eligible_class(op: Op) -> Optional[str]:
    """The fault class ``FaultPlan.random`` may draw for ``op`` (None if
    the op must never be injected)."""
    if op.kind == OpKind.H2D:
        return "h2d_error"
    if op.kind == OpKind.COMPUTE:
        ref = op.payload
        if (isinstance(ref, BlockRef) and ref.kernel in REPLAYABLE_KERNELS
                and len(op.buffers_written) == 1):
            return "compute_nan"
    return None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seeded set of faults for one schedule execution.

    Pass the plan itself to ``ScheduleExecutor.run(faults=...)`` (each run
    builds a fresh one-shot :class:`FaultInjector` from it), or call
    :meth:`injector` explicitly to keep a handle on the injection log.
    """

    specs: Tuple[FaultSpec, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def __len__(self) -> int:
        return len(self.specs)

    def __bool__(self) -> bool:
        return bool(self.specs)

    @classmethod
    def random(cls, seed: int, sched: Schedule, rate: float,
               classes: Sequence[str] = ("h2d_error", "compute_nan"),
               max_faults: Optional[int] = None) -> "FaultPlan":
        """Bernoulli(``rate``) draw over the schedule's eligible ops,
        deterministic in ``seed``: the conformance fuzzer's generator."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        rng = np.random.default_rng(seed)
        allowed = frozenset(classes)
        specs: List[FaultSpec] = []
        for i, op in enumerate(sched.ops):
            c = _eligible_class(op)
            # one rng draw per op regardless of eligibility, so the plan
            # for a given (seed, schedule) never shifts when the allowed
            # class set changes
            hit = rng.random() < rate
            if c is None or c not in allowed or not hit:
                continue
            specs.append(FaultSpec(op=i, cls=c, stream=op.stream))
            if max_faults is not None and len(specs) >= max_faults:
                break
        return cls(tuple(specs), seed=seed)

    def for_device(self, name: str) -> "FaultPlan":
        """Sub-plan of the specs pinned to device ``name`` (plus unpinned
        ones) — how a hybrid-level plan shards over member executors."""
        keep = tuple(s for s in self.specs
                     if s.device is None or s.device == name)
        return FaultPlan(keep, seed=self.seed)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """Mutable per-run consumption state over a :class:`FaultPlan`.

    ``check(i, op)`` is consulted once per *attempt* of op ``i`` and
    consumes one occurrence: a spec with ``times=k`` faults the op's
    first ``k`` attempts.  Every consumed fault is appended to
    ``injected`` as ``(op_index, cls)`` — the ground truth the fuzzer
    reconciles byte counters against.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._live: Dict[int, List[List]] = {}
        for s in plan.specs:
            self._live.setdefault(s.op, []).append(
                [s.cls, s.times, s.stream])
        self.injected: List[Tuple[int, str]] = []

    def check(self, i: int, op: Op) -> Optional[str]:
        """Fault class to inject for this attempt of op ``i``, or None."""
        queue = self._live.get(i)
        if not queue:
            return None
        cls, remaining, stream = queue[0]
        if stream is not None and stream != op.stream:
            raise ValueError(
                f"fault plan pins op {i} to stream {stream} but the "
                f"schedule runs it on stream {op.stream}")
        if remaining <= 1:
            queue.pop(0)
            if not queue:
                del self._live[i]
        else:
            queue[0][1] = remaining - 1
        self.injected.append((i, cls))
        return cls

    def exhausted(self) -> bool:
        """True once every planned fault has been consumed."""
        return not self._live
