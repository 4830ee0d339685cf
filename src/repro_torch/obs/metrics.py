"""Port of ``src/repro/obs/metrics.py`` (JAX-free), held against it by
``tests/test_torch_executor.py``; a copy of the reference apart from its
imports.

Process-wide metric registry — labeled counters, gauges, histograms.

The paper's claims are *measured* claims (<=10 % abstraction overhead,
pipeline overlap), so the engine needs one uniform place every layer reports
into instead of the ad-hoc ``last_h2d_bytes`` / ``hits`` attributes that
accumulated per subsystem.  This module is that place: a zero-dependency
:class:`MetricRegistry` of metric *families* keyed by name, each family
holding one sample per label set.

Design constraints (DESIGN.md §10):

  * **Cheap when disabled.**  The registry starts disabled; ``inc``/``set``/
    ``observe`` check one bool and return.  Instrumented hot paths publish
    per *run*, never per op, so the disabled cost is a handful of branches
    per kernel call (guarded <2 % in ``benchmarks/bench_overhead.py``).
  * **Thread-safe.**  One registry lock serializes family creation and
    sample updates — publishes happen at run granularity, so a single lock
    is never contended enough to matter.
  * **Exportable and comparable.**  ``snapshot()`` is a plain-JSON document
    that round-trips through :meth:`MetricRegistry.from_snapshot`;
    ``to_prometheus_text()`` is the Prometheus v0.0.4 text exposition, so
    sidecars diff cleanly across runs and CI artifacts.

Naming scheme: ``repro_<layer>_<name>`` with snake_case names and
``_total`` / ``_bytes`` / ``_seconds`` unit suffixes, e.g.
``repro_executor_h2d_bytes{kernel="gemm"}``.  The fault-injection /
recovery subsystem publishes under ``repro_fault_*`` (DESIGN.md §12):
``repro_fault_injected_total``, ``repro_fault_retries_total``,
``repro_fault_replayed_ops_total``, ``repro_fault_replayed_h2d_bytes``,
``repro_fault_recoveries_total{action=...}`` and the
``repro_fault_backoff_seconds`` histogram.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Default histogram buckets: log-ish spacing covering microseconds..minutes,
# which is the span of everything the engine times (op launch to factorization
# wall time).
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 60.0, 600.0)

# Retry-backoff sleeps are much shorter than op/run durations: exponential
# schedules starting at ~10ms, a handful of doublings.
BACKOFF_BUCKETS = (1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 0.5, 1.0, 5.0, 30.0)


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    # integers print as integers so golden exposition tests are stable
    if float(v).is_integer() and abs(v) < 2**63:
        return str(int(v))
    return repr(float(v))


def _escape_label_value(v: str) -> str:
    # Prometheus text format: backslash, double quote and newline must be
    # escaped inside label values (spaces and other bytes pass through)
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + body + "}"


class Metric:
    """One metric family: a name, a type, and one sample per label set."""

    kind = "untyped"

    def __init__(self, registry: "MetricRegistry", name: str, help: str = ""):
        self._reg = registry
        self.name = name
        self.help = help
        self._samples: Dict[LabelKey, float] = {}

    # -- introspection ------------------------------------------------------
    def value(self, **labels) -> float:
        with self._reg._lock:
            return self._samples.get(_label_key(labels), 0.0)

    def samples(self) -> Dict[LabelKey, float]:
        with self._reg._lock:
            return dict(self._samples)

    # -- exposition ---------------------------------------------------------
    def _expo_lines(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in sorted(self._samples.items())]

    def _snap(self) -> dict:
        return {
            "name": self.name, "type": self.kind, "help": self.help,
            "samples": [{"labels": dict(k), "value": v}
                        for k, v in sorted(self._samples.items())],
        }

    def _restore(self, samples: Iterable[dict]) -> None:
        for s in samples:
            self._samples[_label_key(s.get("labels", {}))] = float(s["value"])


class Counter(Metric):
    """Monotone accumulator.  ``inc(n, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._reg.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._reg._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount


class Gauge(Metric):
    """Point-in-time value.  ``set(v, **labels)`` / ``add(v, **labels)``."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self._samples[_label_key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._reg._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount


class Histogram(Metric):
    """Cumulative-bucket histogram.  ``observe(v, **labels)``.

    Stored per label set as ``(bucket counts, sum, count)``; exposition
    follows Prometheus (``_bucket{le=...}`` cumulative, ``+Inf`` = count).
    """

    kind = "histogram"

    def __init__(self, registry: "MetricRegistry", name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._hist: Dict[LabelKey, List[float]] = {}  # [counts..., sum, count]

    def observe(self, value: float, **labels) -> None:
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._reg._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    h[i] += 1
            h[-2] += float(value)
            h[-1] += 1

    def stats(self, **labels) -> Tuple[float, float]:
        """(sum, count) for one label set."""
        with self._reg._lock:
            h = self._hist.get(_label_key(labels))
            return (h[-2], h[-1]) if h else (0.0, 0.0)

    def _expo_lines(self) -> List[str]:
        lines = []
        for key, h in sorted(self._hist.items()):
            cum = 0.0
            for i, b in enumerate(self.buckets):
                cum = h[i]
                lines.append(f"{self.name}_bucket"
                             f"{_fmt_labels(key, (('le', repr(float(b))),))}"
                             f" {_fmt_value(cum)}")
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, (('le', '+Inf'),))}"
                         f" {_fmt_value(h[-1])}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(h[-2])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{_fmt_value(h[-1])}")
        return lines

    def _snap(self) -> dict:
        return {
            "name": self.name, "type": self.kind, "help": self.help,
            "buckets": list(self.buckets),
            "samples": [
                {"labels": dict(k),
                 "counts": [c for c in h[:-2]],
                 "sum": h[-2], "count": h[-1]}
                for k, h in sorted(self._hist.items())
            ],
        }

    def _restore(self, samples: Iterable[dict]) -> None:
        for s in samples:
            self._hist[_label_key(s.get("labels", {}))] = (
                [float(c) for c in s["counts"]]
                + [float(s["sum"]), float(s["count"])])


class MetricRegistry:
    """Registry of metric families.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent per name); re-declaring a name as a different
    type raises."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}

    # -- family factories ---------------------------------------------------
    def _family(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every family (sidecar emission resets between sections)."""
        with self._lock:
            self._metrics.clear()

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON document; round-trips via :meth:`from_snapshot`."""
        with self._lock:
            return {"metrics": [self._metrics[n]._snap()
                                for n in sorted(self._metrics)]}

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus_text(self) -> str:
        """Prometheus v0.0.4 text exposition (# HELP / # TYPE + samples)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                lines.extend(m._expo_lines())
        return "\n".join(lines) + "\n"

    @classmethod
    def from_snapshot(cls, snap: dict,
                      enabled: bool = True) -> "MetricRegistry":
        """Rebuild a registry from :meth:`snapshot` output (or its JSON)."""
        if isinstance(snap, str):
            snap = json.loads(snap)
        reg = cls(enabled=enabled)
        for m in snap.get("metrics", ()):
            kind = m.get("type", "counter")
            if kind == "counter":
                fam: Metric = reg.counter(m["name"], m.get("help", ""))
            elif kind == "gauge":
                fam = reg.gauge(m["name"], m.get("help", ""))
            elif kind == "histogram":
                fam = reg.histogram(m["name"], m.get("help", ""),
                                    buckets=m.get("buckets",
                                                  DEFAULT_BUCKETS))
            else:
                raise ValueError(f"unknown metric type {kind!r}")
            fam._restore(m.get("samples", ()))
        return reg
