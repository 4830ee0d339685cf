"""Port of ``src/repro/obs/spans.py`` (JAX-free), held against it by
``tests/test_torch_executor.py``; a copy of the reference apart from its
imports. Its ``core.trace`` import points at the port.

Hierarchical tracing — one coherent timeline for a whole OOC run.

Before this module the engine had two flat span sources (the simulator's
``op_spans`` and ``ScheduleExecutor.record_spans`` wall-clock tuples) and
one exporter (``core/trace.py``), but no way to see a *run* — tuner search,
plan-cache lookups, per-device executors and the hybrid merge — on a single
timeline.  :class:`Tracer` provides that:

  * **Hierarchical spans** — ``with tracer.span("tune.search", kernel=...)``
    opens a span on the *calling thread's* stack; nested spans record their
    parent id, so the control flow (plan -> search -> simulate, run ->
    merge) reconstructs exactly.  Each OS thread renders as its own track.
  * **Flat span groups** — :meth:`add_flat_spans` absorbs the engine's
    existing ``(tag, stream, start_s, end_s)`` tuples (executor or
    simulator) as one *trace process* per group, shifted onto the tracer's
    clock, so per-device pipelines sit beside the control timeline without
    stream-id collisions (the ``chrome_trace_groups`` convention: pid =
    group index, here offset by 1 because pid 0 is the control process).

Export is Chrome-trace JSON via the same helpers as ``core/trace.py``
(:meth:`to_chrome_trace` / :meth:`write`), so one file opened at
``chrome://tracing`` / ui.perfetto.dev shows the entire run.

A tracer is *active* only while installed on the process
:class:`~repro_torch.obs.Observability`; instrumented code does ``tr =
obs.tracer`` and skips everything when it is None, so tracing costs nothing
when off.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

FlatSpan = Tuple[str, int, float, float]            # (tag, stream, start, end)
Reuse = Dict[str, Dict[str, int]]


@dataclasses.dataclass(frozen=True)
class TraceSpan:
    """One closed hierarchical span (times relative to the tracer epoch)."""

    name: str
    cat: str
    span_id: int
    parent_id: Optional[int]
    tid: int                 # tracer-local thread index (track)
    start: float
    end: float
    args: Tuple[Tuple[str, str], ...] = ()

    @property
    def duration(self) -> float:
        return self.end - self.start


class _SpanHandle:
    """Context manager yielded by :meth:`Tracer.span`; closes on exit."""

    __slots__ = ("_tracer", "name", "cat", "span_id", "parent_id", "tid",
                 "start", "_args")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 span_id: int, parent_id: Optional[int], tid: int,
                 start: float, args: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.start = start
        self._args = dict(args)

    def annotate(self, **kw) -> None:
        """Attach extra key/values to the span before it closes."""
        self._args.update(kw)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._close(self)
        return None


class Tracer:
    """Hierarchical tracer with per-thread span stacks.

    ``clock`` defaults to ``time.perf_counter``; all recorded times are
    relative to the tracer's construction (its *epoch*), which is also the
    reference :meth:`add_flat_spans` offsets against.
    """

    def __init__(self, name: str = "ooc-run", clock=time.perf_counter):
        self.name = name
        self._clock = clock
        self.epoch = clock()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: List[TraceSpan] = []
        self._groups: List[Tuple[str, List[FlatSpan], Optional[Reuse]]] = []
        self._local = threading.local()
        self._tids: Dict[int, int] = {}   # thread ident -> track index

    # -- clock --------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the tracer epoch."""
        return self._clock() - self.epoch

    # -- hierarchical spans --------------------------------------------------
    def _stack(self) -> List[_SpanHandle]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            return tid

    def span(self, name: str, cat: str = "phase", **args) -> _SpanHandle:
        """Open a span on this thread's stack (use as a context manager)."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        h = _SpanHandle(self, name, cat, next(self._ids), parent,
                        self._tid(), self.now(), args)
        stack.append(h)
        return h

    def instant(self, name: str, cat: str = "instant", **args) -> None:
        """Record a zero-duration marker at the current time — fault
        injections and recovery actions stamp the timeline with these so
        a trace shows *where* in the schedule the fault landed."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        t = self.now()
        h = _SpanHandle(self, name, cat, next(self._ids), parent,
                        self._tid(), t, args)
        self._record(h, t)

    def _close(self, h: _SpanHandle) -> None:
        end = self.now()
        stack = self._stack()
        # tolerate exits out of order (a handle closed twice, or from a
        # different frame): pop back to — and including — this handle
        while stack:
            top = stack.pop()
            if top is h:
                break
        self._record(h, end)

    def _record(self, h: _SpanHandle, end: float) -> None:
        span = TraceSpan(
            name=h.name, cat=h.cat, span_id=h.span_id,
            parent_id=h.parent_id, tid=h.tid, start=h.start, end=end,
            args=tuple(sorted((str(k), str(v))
                              for k, v in h._args.items())))
        with self._lock:
            self._spans.append(span)

    # -- flat span groups ----------------------------------------------------
    def add_flat_spans(self, name: str, spans: Iterable[FlatSpan],
                       offset: float = 0.0,
                       reuse: Optional[Reuse] = None) -> None:
        """Absorb an executor's / simulator's flat span list as one trace
        process.  ``offset`` places the group's zero on the tracer clock
        (e.g. ``tracer.now()`` captured when the run started)."""
        shifted = [(tag, stream, start + offset, end + offset)
                   for tag, stream, start, end in spans]
        with self._lock:
            self._groups.append((name, shifted, reuse))

    # -- introspection -------------------------------------------------------
    def spans(self) -> List[TraceSpan]:
        with self._lock:
            return list(self._spans)

    def groups(self) -> List[Tuple[str, List[FlatSpan]]]:
        with self._lock:
            return [(name, list(sp)) for name, sp, _ in self._groups]

    def summary(self) -> dict:
        """Span/group counts plus total span seconds, per process."""
        with self._lock:
            out = {
                "control_spans": len(self._spans),
                "groups": {
                    name: {"spans": len(sp),
                           "span_seconds": sum(e - s for _, _, s, e in sp)}
                    for name, sp, _ in self._groups
                },
            }
        return out

    # -- export --------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """One Chrome-trace document: pid 0 is the control process (the
        hierarchical spans, one track per thread), pids 1..N are the flat
        groups in absorption order — the exact lane-group convention of
        :func:`repro_torch.core.trace.chrome_trace_groups`."""
        # lazy import: repro_torch.obs must stay importable before repro_torch.core
        from repro_torch.core.trace import _group_events

        with self._lock:
            spans = list(self._spans)
            groups = list(self._groups)
        events: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": self.name},
        }]
        for tid in sorted({s.tid for s in spans}):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": f"thread {tid}"},
            })
        for s in sorted(spans, key=lambda s: s.start):
            args = dict(s.args)
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": s.start * 1e6,
                "dur": max(s.duration, 0.0) * 1e6,
                "pid": 0, "tid": s.tid, "args": args,
            })
        for i, (name, flat, reuse) in enumerate(groups):
            events.extend(_group_events(flat, name, pid=i + 1, reuse=reuse))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
