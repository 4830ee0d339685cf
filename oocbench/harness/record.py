"""What a run records for its metric readers.

The program's executor already counts what the readers need; the harness
keeps a copy of each run's counters, spans and schedule by subclassing it
(:func:`recording_executor`), and changes nothing of what it does.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional, Tuple

Span = Tuple[str, int, float, float]


@dataclasses.dataclass
class ExecRun:
    """One ``ScheduleExecutor.run``: its schedule, the host operands'
    shapes by name, its ``ctx``, and the executor's counters after it."""
    sched: Any
    shapes: Dict[str, Tuple[int, ...]]
    ctx: Dict[str, Any]
    wall_s: float
    stage_s: float
    stage_wait_s: float
    h2d_bytes: int
    d2h_bytes: int
    spans: List[Span]


@dataclasses.dataclass
class Call:
    """One call of the entry point in the window."""
    operand_set: int
    wall_s: float
    flops: float
    execs: List[ExecRun]


@dataclasses.dataclass
class Profile:
    """The device's side of a traced window, from ``torch.profiler``."""
    window_s: float
    busy_s: float
    device_ops: List[List[Any]]
    idle_gaps: List[List[Any]]


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""
    cell: dict
    config: dict
    traffic: dict
    peaks: Optional[dict]
    setup_s: float
    window_s: float
    calls: List[Call]
    profile: Optional[Profile] = None

    @property
    def execs(self) -> List[ExecRun]:
        return [e for c in self.calls for e in c.execs]

    def peak_flops(self) -> Optional[float]:
        if self.peaks is None:
            return None
        return self.peaks["flops"].get(self.config["dtype"])

    @staticmethod
    def note(msg: str) -> None:
        print(f"[oocbench] {msg}", file=sys.stderr, flush=True)


def _shape(x) -> Tuple[int, ...]:
    return tuple(int(d) for d in x.shape)


def recording_executor(**kwargs):
    """A ``ScheduleExecutor`` (made with ``kwargs``) that appends an
    :class:`ExecRun` to its ``runs`` after every run."""
    from repro_torch.core import ScheduleExecutor

    class RecordingExecutor(ScheduleExecutor):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.runs: List[ExecRun] = []

        def run(self, sched, operands, outputs, ctx=None, faults=None,
                policy=None):
            st = super().run(sched, operands, outputs, ctx, faults, policy)
            shapes = {k: _shape(v) for k, v in operands.items()}
            shapes.update({k: _shape(v) for k, v in outputs.items()})
            self.runs.append(ExecRun(
                sched=sched, shapes=shapes, ctx=dict(ctx or {}),
                wall_s=self.last_wall_seconds,
                stage_s=self.last_stage_seconds,
                stage_wait_s=self.last_stage_wait_seconds,
                h2d_bytes=self.last_h2d_bytes,
                d2h_bytes=self.last_d2h_bytes,
                spans=list(self.last_spans) if self.record_spans else []))
            return st

    return RecordingExecutor(**kwargs)
