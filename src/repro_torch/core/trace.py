"""Port of ``src/repro/core/trace.py`` (JAX-free), held against it by
``tests/test_torch_planning.py``; a copy of the reference apart from its
imports.

Chrome-trace export — make pipeline overlap visually inspectable.

The paper argues its claims (C3/C5) from *overlap*: transfers hidden behind
DGEMM, stream width matched to the engine topology.  A timeline is the
honest way to check that, so both span sources the engine produces —
:attr:`~repro_torch.core.simulator.SimResult.op_spans` (engine-model time) and
:class:`~repro_torch.core.runtime.ScheduleExecutor` wall-clock timings — export to
the ``chrome://tracing`` / Perfetto JSON event format through one helper.
Load the file at ``chrome://tracing`` or https://ui.perfetto.dev.

A span is ``(tag, stream, start_s, end_s)``; streams become trace threads so
each stream renders as its own track.  Categories derive from the schedule's
tag grammar (``S(..)`` H2D, ``R(..)`` D2H, anything else compute), which is
also what Perfetto's search/filter keys on.

Multi-device runs (the hybrid co-scheduler) have one span list *per device*,
each with its own stream indices starting at 0; merging them onto one pid
would collide the tracks.  :func:`chrome_trace_groups` gives every device
its own trace *process* (``pid`` = device index), so Perfetto renders one
lane-group per device and identical stream ids never collide.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Span = Tuple[str, int, float, float]
Reuse = Dict[str, Dict[str, int]]


def _category(tag: str) -> str:
    if tag.startswith("S("):
        return "h2d"
    if tag.startswith("R("):
        return "d2h"
    return "compute"


def _group_events(spans: Iterable[Span], process_name: str,
                  pid: int, reuse: Optional[Reuse] = None) -> List[dict]:
    """Events for one span source under one trace process."""
    spans = list(spans)
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for tid in sorted({s[1] for s in spans}):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"stream {tid}"},
        })
    for tag, stream, start, end in spans:
        events.append({
            "name": tag,
            "cat": _category(tag),
            "ph": "X",
            "ts": start * 1e6,
            "dur": max(end - start, 0.0) * 1e6,
            "pid": pid,
            "tid": stream,
        })
    if reuse:
        # every H2D on the timeline is a cache miss; hits are the transfers
        # that are *not* there — surface them as an instant annotation
        hits = sum(r["hits"] for r in reuse.values())
        misses = sum(r["misses"] for r in reuse.values())
        events.append({
            "name": f"block-cache: {hits} hits / {misses} transfers",
            "cat": "reuse", "ph": "I", "s": "p",
            "ts": 0.0, "pid": pid, "tid": 0,
            "args": {k: dict(v) for k, v in reuse.items()},
        })
    return events


def chrome_trace(spans: Iterable[Span],
                 process_name: str = "ooc-pipeline",
                 pid: int = 0, reuse: Optional[Reuse] = None) -> dict:
    """Spans -> a ``chrome://tracing`` JSON object (complete "X" events,
    microsecond timestamps, one thread per stream).  ``reuse`` (a schedule's
    block-cache counters) adds an instant event annotating how many H2D
    transfers the residency cache elided."""
    return {"traceEvents": _group_events(spans, process_name, pid, reuse),
            "displayTimeUnit": "ms"}


def chrome_trace_groups(
        groups: Sequence[Tuple[str, Iterable[Span]]]) -> dict:
    """``[(device_name, spans), ...]`` -> one trace with a process (lane
    group) per device: ``pid`` is the device's position in ``groups``, so
    spans from concurrently recorded executors — whose stream ids all start
    at 0 — land on separate tracks instead of colliding."""
    events: List[dict] = []
    for pid, (name, spans) in enumerate(groups):
        events.extend(_group_events(spans, name, pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span],
                       process_name: str = "ooc-pipeline",
                       reuse: Optional[Reuse] = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, process_name=process_name,
                               reuse=reuse), f)


def write_chrome_trace_groups(
        path: str, groups: Sequence[Tuple[str, Iterable[Span]]]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace_groups(groups), f)
