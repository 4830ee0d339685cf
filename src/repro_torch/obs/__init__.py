"""repro_torch.obs — the observability layer of the port.

Port of ``src/repro/obs/__init__.py``: the process-wide
:class:`Observability` bundle (metrics registry, tracer, drift monitor) with
the per-run publication helpers the executor and entry points call:
``record_executor_run``, ``record_drift``, the fault-recovery pair
``record_fault_run`` / ``record_fault_recovery``, and the attribution pair
``record_analysis`` / ``record_whatif``.  Everything starts disabled;
instrumented paths guard on ``obs.metrics.enabled`` / ``obs.tracer is
None`` and publish per-run aggregates only.

Beyond the reference: :meth:`Observability.span` also enters
``torch.profiler.record_function`` while a profiler records, so the port's
spans lie on the device trace's clock, and adds its host seconds to the
thread's open :class:`CallRecord`; :meth:`Observability.call` opens one
per entry-point call (``Observability.calls`` keeps the last few hundred).

``TraceAnalysis``, ``WhatIfReport`` and ``whatif`` resolve lazily from
:mod:`repro_torch.obs.analyze` and :mod:`repro_torch.obs.whatif`, which
import the simulator: this package imports nothing of ``repro_torch.core``
at load (the core runtime imports it first).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs.drift import DriftMonitor, DriftRecord, key_str
from repro_torch.obs.metrics import (BACKOFF_BUCKETS, Counter, Gauge,
                                     Histogram, Metric, MetricRegistry)
from repro_torch.obs.spans import FlatSpan, Tracer, TraceSpan

__all__ = [
    "CallRecord", "Counter", "DriftMonitor", "DriftRecord", "FlatSpan",
    "Gauge", "Histogram", "Metric", "MetricRegistry", "Observability",
    "TraceAnalysis", "TraceSpan", "Tracer", "WhatIfReport",
    "get_observability", "key_str", "whatif",
]

# Attribution lives in submodules that import repro_torch.core (the
# simulator); resolve lazily so ``import repro_torch.obs`` stays core-free.
_LAZY = {
    "TraceAnalysis": ("repro_torch.obs.analyze", "TraceAnalysis"),
    "WhatIfReport": ("repro_torch.obs.whatif", "WhatIfReport"),
    "whatif": ("repro_torch.obs.whatif", "whatif"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target[0]), target[1])


class _NullSpan:
    """No-tracer stand-in so call sites can unconditionally ``with``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def annotate(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()

# completed and failed entry-point calls kept on ``Observability.calls``
CALLS_KEPT = 256


def profiled(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else the shared no-op span: the profiler's timeline then names the host
    work by the program's own span names."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NULL_SPAN


class CallRecord:
    """One entry-point call's host accounting: seconds by span name (the
    call span's own under ``entry``), ``copy_bytes`` that the entry point's
    own host copies wrote, ``exec_walls`` (each executor run's
    ``last_wall_seconds``, appended as the run ends),
    ``direct_h2d_bytes`` (its executor runs' H2D bytes copied straight
    from page-locked operands, ``last_direct_h2d_bytes``), ``fill_bytes``
    (the bytes of the blocks its runs made as zeros on the device,
    ``last_fill_bytes``) and ``ok`` (False when the call raised)."""

    __slots__ = ("entry", "seconds", "copy_bytes", "exec_walls",
                 "direct_h2d_bytes", "fill_bytes", "ok")

    def __init__(self, entry: str):
        self.entry = entry
        self.seconds: Dict[str, float] = {}
        self.copy_bytes = 0
        self.exec_walls: List[float] = []
        self.direct_h2d_bytes = 0
        self.fill_bytes = 0
        self.ok = False

    def add(self, name: str, seconds: float, copy_bytes: int = 0) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.copy_bytes += copy_bytes


class _Span:
    """A span seen by a tracer (``handle``), a recording profiler (``rf``)
    and an open call record (``rec``); an absent one is the no-op span, or
    None for the record."""

    __slots__ = ("_name", "_handle", "_rf", "_rec", "_copy_bytes", "_t0")

    def __init__(self, name, handle, rf, rec, copy_bytes):
        self._name = name
        self._handle = handle
        self._rf = rf
        self._rec = rec
        self._copy_bytes = copy_bytes
        self._t0 = 0.0

    def __enter__(self):
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.add(self._name, time.perf_counter() - self._t0,
                          self._copy_bytes)
        self._rf.__exit__(*exc)
        self._handle.__exit__(*exc)
        return None

    def annotate(self, **kw) -> None:
        self._handle.annotate(**kw)


class _Call(_Span):
    """The outermost span of an entry-point call: it owns the thread's
    :class:`CallRecord` while it is open, and adds its own seconds to it
    under the entry's name."""

    __slots__ = ("_obs",)

    def __init__(self, obs: "Observability", entry: str):
        tr = obs.tracer
        super().__init__(entry, _NULL_SPAN if tr is None
                         else tr.span(entry, cat="call"),
                         profiled(entry), CallRecord(entry), 0)
        self._obs = obs

    def __enter__(self) -> CallRecord:
        super().__enter__()
        self._obs._local.call = self._rec
        return self._rec

    def __exit__(self, exc_type, *exc):
        self._obs._local.call = None
        self._rec.ok = exc_type is None
        super().__exit__(exc_type, *exc)
        self._obs.calls.append(self._rec)
        return None


class Observability:
    """Metrics + tracing + drift, with one enable/disable switch.

    A fresh instance is fully disabled; :func:`get_observability` returns
    the process singleton every instrumented layer reports into.
    """

    def __init__(self):
        self.metrics = MetricRegistry(enabled=False)
        self.drift = DriftMonitor()
        self.tracer: Optional[Tracer] = None
        self.calls: Deque[CallRecord] = collections.deque(maxlen=CALLS_KEPT)
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- switches ------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.metrics.enabled

    def enable(self, metrics: bool = True, trace: bool = False,
               trace_name: str = "ooc-run") -> "Observability":
        self.metrics.enabled = metrics
        if trace and self.tracer is None:
            self.start_trace(trace_name)
        return self

    def disable(self) -> "Observability":
        self.metrics.enabled = False
        self.tracer = None
        return self

    def reset(self) -> "Observability":
        """Drop all collected state (metrics families, drift, trace, call
        records)."""
        self.metrics.reset()
        self.drift.reset()
        self.tracer = None
        self.calls.clear()
        return self

    # -- tracing -------------------------------------------------------------
    def start_trace(self, name: str = "ooc-run") -> Tracer:
        with self._lock:
            self.tracer = Tracer(name)
            return self.tracer

    def stop_trace(self) -> Optional[Tracer]:
        """Detach and return the active tracer (caller exports it)."""
        with self._lock:
            tr, self.tracer = self.tracer, None
            return tr

    def span(self, name: str, cat: str = "phase", copy_bytes: int = 0,
             **args):
        """A span seen by whatever records: the active tracer (a
        hierarchical span), a recording ``torch.profiler`` session
        (``record_function``) and this thread's open call record (its host
        seconds under ``name``, and ``copy_bytes``, the bytes a host copy
        inside it writes).  With none of them, the shared free no-op."""
        tr = self.tracer
        rec = getattr(self._local, "call", None)
        if copy_bytes:
            args["copy_bytes"] = copy_bytes
        handle = _NULL_SPAN if tr is None \
            else tr.span(name, cat=cat, **args)
        if rec is None and not _autograd_profiler._is_profiler_enabled:
            return handle
        return _Span(name, handle, profiled(name), rec, copy_bytes)

    def call(self, entry: str, record: bool):
        """The outermost span of one entry-point call (``gemm``,
        ``cholesky``, ...).  It opens this thread's :class:`CallRecord`
        when ``record`` (the caller's executor records spans) or a tracer
        is active; the record joins :attr:`calls` when the call ends, as
        failed if it raised.  A call inside an open one (an entry point's
        nested trailing update) is a plain span of the outer record."""
        if getattr(self._local, "call", None) is not None \
                or not (record or self.tracer is not None):
            return self.span(entry, cat="call")
        return _Call(self, entry)

    def add_exec_run(self, wall_seconds: float, land_seconds: float,
                     direct_h2d_bytes: int = 0, fill_bytes: int = 0) -> None:
        """An executor run that ended on this thread: its wall joins the
        open call record's ``exec_walls``, its write-back landing joins its
        seconds as ``executor.land``, its direct H2D bytes its
        ``direct_h2d_bytes``, its filled bytes its ``fill_bytes``.  Without
        an open record, nothing."""
        rec = getattr(self._local, "call", None)
        if rec is not None:
            rec.exec_walls.append(wall_seconds)
            rec.add("executor.land", land_seconds)
            rec.direct_h2d_bytes += direct_h2d_bytes
            rec.fill_bytes += fill_bytes

    def instant(self, name: str, cat: str = "fault", **args) -> None:
        """A zero-duration trace marker when tracing is active, else a free
        no-op."""
        tr = self.tracer
        if tr is not None:
            tr.instant(name, cat=cat, **args)

    # -- per-run publication helpers ----------------------------------------
    def record_executor_run(self, sched, wall_seconds: float,
                            h2d_bytes: int, d2h_bytes: int,
                            spans: Optional[List[FlatSpan]] = None,
                            direct_h2d_bytes: int = 0,
                            fill_bytes: int = 0) -> None:
        """Publish one :meth:`ScheduleExecutor.run`'s aggregates; its H2D
        bytes copied straight from page-locked operands, where there are
        any, as ``repro_executor_direct_h2d_bytes``, and the bytes of the
        blocks its fill ops made on the device, where there are any, as
        ``repro_executor_fill_bytes`` (a run that staged every copy and
        filled nothing publishes what the reference's run does)."""
        if not self.metrics.enabled:
            return
        kernel = sched.meta.get("kernel", "unknown")
        m = self.metrics
        m.counter("repro_executor_runs_total",
                  "schedules executed").inc(kernel=kernel)
        m.counter("repro_executor_h2d_bytes",
                  "bytes moved host->device").inc(h2d_bytes, kernel=kernel)
        m.counter("repro_executor_d2h_bytes",
                  "bytes moved device->host").inc(d2h_bytes, kernel=kernel)
        if direct_h2d_bytes:
            m.counter("repro_executor_direct_h2d_bytes",
                      "bytes moved host->device straight from page-locked "
                      "operands").inc(direct_h2d_bytes, kernel=kernel)
        if fill_bytes:
            m.counter("repro_executor_fill_bytes",
                      "bytes of blocks made as zeros on the device in place "
                      "of an H2D").inc(fill_bytes, kernel=kernel)
        m.counter("repro_executor_flops_total",
                  "modeled flops of executed compute ops").inc(
                      sched.total_flops(), kernel=kernel)
        kinds: Dict[str, int] = {}
        for op in sched.ops:
            kinds[op.kind.name.lower()] = kinds.get(
                op.kind.name.lower(), 0) + 1
        for kind, n in kinds.items():
            m.counter("repro_executor_ops_total",
                      "ops executed by kind").inc(n, kernel=kernel,
                                                  kind=kind)
        m.histogram("repro_executor_run_seconds",
                    "wall seconds per executed schedule").observe(
                        wall_seconds, kernel=kernel)
        for operand, r in sched.reuse.items():
            m.counter("repro_executor_blockcache_hits_total",
                      "block-cache hits (H2D transfers elided)").inc(
                          r.get("hits", 0), kernel=kernel, operand=operand)
            m.counter("repro_executor_blockcache_misses_total",
                      "block-cache misses (H2D transfers performed)").inc(
                          r.get("misses", 0), kernel=kernel, operand=operand)
            m.counter("repro_executor_blockcache_evictions_total",
                      "block-cache evictions").inc(
                          r.get("evictions", 0), kernel=kernel,
                          operand=operand)
            m.counter("repro_executor_blockcache_saved_bytes",
                      "H2D bytes elided by block reuse").inc(
                          r.get("bytes_saved", 0), kernel=kernel,
                          operand=operand)
        if spans:
            busy: Dict[int, float] = {}
            for _, stream, start, end in spans:
                busy[stream] = busy.get(stream, 0.0) + max(end - start, 0.0)
            for stream, b in sorted(busy.items()):
                m.gauge("repro_executor_stream_busy_seconds",
                        "recorded busy seconds per stream, last run").set(
                            b, kernel=kernel, stream=str(stream))

    def record_fault_run(self, kernel: str, stats: Dict[str, float]) -> None:
        """Publish one fault-injected executor run's recovery accounting
        (DESIGN.md §12) — the ``repro_fault_*`` family.  Called once per
        faulted run, including runs that end in an unrecoverable raise."""
        if not self.metrics.enabled:
            return
        m = self.metrics
        m.counter("repro_fault_injected_total",
                  "faults injected into executor runs").inc(
                      stats.get("injected", 0), kernel=kernel)
        m.counter("repro_fault_retries_total",
                  "transfer retry attempts").inc(
                      stats.get("retries", 0), kernel=kernel)
        m.counter("repro_fault_replayed_ops_total",
                  "compute ops re-executed by block-granular replay").inc(
                      stats.get("replayed_ops", 0), kernel=kernel)
        m.counter("repro_fault_replayed_h2d_bytes",
                  "extra H2D traffic caused by recovery (separate from "
                  "the nominal executor byte counters)").inc(
                      stats.get("replayed_h2d_bytes", 0), kernel=kernel)
        for action in ("retry", "replay"):
            n = stats.get(f"recovered_{action}", 0)
            if n:
                m.counter("repro_fault_recoveries_total",
                          "successful recovery actions").inc(
                              n, kernel=kernel, action=action)
        backoff = stats.get("backoff_seconds", 0.0)
        if backoff:
            m.histogram("repro_fault_backoff_seconds",
                        "total backoff slept per faulted run",
                        buckets=BACKOFF_BUCKETS).observe(backoff,
                                                         kernel=kernel)

    def record_fault_recovery(self, kernel: str, action: str,
                              **labels) -> None:
        """Publish one out-of-executor recovery action (``rebalance`` for
        device_lost, ``degrade`` for oom ladders) into the same
        ``repro_fault_recoveries_total`` family the executor uses."""
        if not self.metrics.enabled:
            return
        self.metrics.counter("repro_fault_recoveries_total",
                             "successful recovery actions").inc(
                                 kernel=kernel, action=action, **labels)

    def record_drift(self, kernel: str, tier: str, fingerprint: str,
                     **kw) -> Optional[DriftRecord]:
        """Record a predicted-vs-measured pair (when enabled) and mirror the
        rolling ratio into the metric registry."""
        if not self.metrics.enabled:
            return None
        rec = self.drift.record(kernel, tier, fingerprint, **kw)
        m = self.metrics
        m.counter("repro_drift_records_total",
                  "predicted-vs-measured pairs recorded").inc(
                      kernel=kernel, tier=tier)
        m.gauge("repro_drift_time_ratio",
                "rolling measured/predicted makespan ratio").set(
                    self.drift.ratio(kernel, tier, fingerprint),
                    kernel=kernel, tier=tier)
        m.gauge("repro_drift_byte_ratio",
                "last measured/predicted H2D byte ratio (must be 1.0)").set(
                    rec.byte_ratio, kernel=kernel, tier=tier)
        return rec

    def record_analysis(self, analysis, kernel: str = "unknown") -> None:
        """Publish one :class:`~repro_torch.obs.analyze.TraceAnalysis` as the
        ``repro_analysis_*`` metric family (duck-typed: no analyze import,
        this package must stay core-free at load)."""
        if not self.metrics.enabled:
            return
        m = self.metrics
        m.counter("repro_analysis_runs_total",
                  "trace attributions computed").inc(kernel=kernel)
        m.gauge("repro_analysis_makespan_seconds",
                "analyzed timeline makespan, last run").set(
                    analysis.makespan, kernel=kernel)
        m.gauge("repro_analysis_verdict_info",
                "bottleneck verdict of the last analyzed run (value=1)").set(
                    1, kernel=kernel, verdict=analysis.verdict)
        for st in analysis.streams:
            m.gauge("repro_analysis_stream_utilization",
                    "per-stream busy fraction of the analyzed makespan").set(
                        st.utilization, kernel=kernel, stream=str(st.stream))
        for cls, secs in sorted(analysis.class_seconds.items()):
            m.gauge("repro_analysis_critical_path_seconds",
                    "critical-path seconds per segment class").set(
                        secs, kernel=kernel, **{"class": cls})

    def record_whatif(self, report, kernel: str = "unknown") -> None:
        """Publish a :class:`~repro_torch.obs.whatif.WhatIfReport`'s marginal
        gains as ``repro_analysis_whatif_gain_seconds``."""
        if not self.metrics.enabled:
            return
        m = self.metrics
        for sc in report.scenarios:
            if not sc.feasible or sc.knob == "baseline":
                continue
            m.gauge("repro_analysis_whatif_gain_seconds",
                    "marginal makespan gain per scaled resource").set(
                        sc.gain_seconds, kernel=kernel, scenario=sc.name)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON document: metrics + drift (+ trace summary if active)."""
        out = {"metrics": self.metrics.snapshot()["metrics"],
               "drift": self.drift.snapshot()}
        if self.tracer is not None:
            out["trace"] = self.tracer.summary()
        return out


_OBS = Observability()


def get_observability() -> Observability:
    """The process-wide bundle every instrumented layer reports into."""
    return _OBS
