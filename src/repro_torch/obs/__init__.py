"""repro_torch.obs — the observability layer of the port.

Port of ``src/repro/obs/__init__.py``: the process-wide
:class:`Observability` bundle (metrics registry, tracer, drift monitor) with
the per-run publication helpers this slice's executor and entry points call,
``record_executor_run`` and ``record_drift``.  Everything starts disabled;
instrumented paths guard on ``obs.metrics.enabled`` / ``obs.tracer is None``
and publish per-run aggregates only.

Not in this slice: the fault, analysis and what-if publishers and the lazy
``TraceAnalysis`` / ``WhatIfReport`` / ``whatif`` exports, which wait for
ROADMAP module items 6 and 9.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from repro_torch.obs.drift import DriftMonitor, DriftRecord, key_str
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metric,
                                     MetricRegistry)
from repro_torch.obs.spans import FlatSpan, Tracer, TraceSpan

__all__ = [
    "Counter", "DriftMonitor", "DriftRecord", "FlatSpan", "Gauge",
    "Histogram", "Metric", "MetricRegistry", "Observability", "TraceSpan",
    "Tracer", "get_observability", "key_str",
]

_NOT_PORTED = {"TraceAnalysis", "WhatIfReport", "whatif"}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"repro_torch.obs.{name} is not ported yet (ROADMAP module "
            f"item 9: obs/analyze.py and obs/whatif.py)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


class Observability:
    """Metrics + tracing + drift, with one enable/disable switch.

    A fresh instance is fully disabled; :func:`get_observability` returns
    the process singleton every instrumented layer reports into.
    """

    def __init__(self):
        self.metrics = MetricRegistry(enabled=False)
        self.drift = DriftMonitor()
        self.tracer: Optional[Tracer] = None
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
        """Drop all collected state (metrics families, drift, trace)."""
        self.metrics.reset()
        self.drift.reset()
        self.tracer = None
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

    def span(self, name: str, cat: str = "phase", **args):
        """A tracer span when tracing is active, else a free no-op."""
        tr = self.tracer
        return tr.span(name, cat=cat, **args) if tr is not None \
            else _NULL_SPAN

    def instant(self, name: str, cat: str = "fault", **args) -> None:
        """A zero-duration trace marker when tracing is active, else a free
        no-op."""
        tr = self.tracer
        if tr is not None:
            tr.instant(name, cat=cat, **args)

    # -- per-run publication helpers ----------------------------------------
    def record_executor_run(self, sched, wall_seconds: float,
                            h2d_bytes: int, d2h_bytes: int,
                            spans: Optional[List[FlatSpan]] = None) -> None:
        """Publish one :meth:`ScheduleExecutor.run`'s aggregates."""
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
