"""Port of ``src/repro/obs/drift.py`` (JAX-free), held against it by
``tests/test_torch_executor.py``; a copy of the reference apart from its
imports.

Simulate-vs-actual drift — when can ``tune="auto"`` still be trusted?

Every tuned execution carries a prediction: the plan's ``makespan`` came
from :func:`repro_torch.core.simulator.simulate` under a calibrated
:class:`~repro_torch.tune.calibrate.HardwareProfile`, and the compiled schedule's
byte totals are the modeled transfer traffic.  This module records the
*measured* wall time and executor byte counters next to those predictions,
per ``(kernel, tier, fingerprint)``, and maintains rolling drift ratios:

    time_ratio  = measured_seconds / predicted_makespan
    byte_ratio  = measured_h2d_bytes / predicted_h2d_bytes

Byte ratios must be exactly 1.0 (the executor performs the transfers the
schedule ordered; ``tests/test_obs.py`` asserts it) — any deviation is an
engine bug.  Time ratios are the calibration-staleness signal: a *stable*
ratio (even far from 1.0 — this container's wall clock is not a K40c) means
the profile still ranks candidates faithfully; a ratio that trends away
from its own history means the machine no longer matches the profile and
plans chosen by ``tune="auto"`` can no longer be trusted, so recalibrate.

The monitor is bounded (a deque per key, a capped global record list) and
thread-safe; it is always safe to call — recording into a disabled
:class:`~repro_torch.obs.Observability` is simply skipped by the caller.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

DriftKey = Tuple[str, str, str]          # (kernel, tier, fingerprint)

_MAX_RECORDS = 1024                      # global history cap


def _ratio(measured: float, predicted: float) -> float:
    if predicted <= 0:
        return float("inf") if measured > 0 else 1.0
    return measured / predicted


@dataclasses.dataclass(frozen=True)
class DriftRecord:
    """One executed schedule's prediction next to its measurement."""

    kernel: str
    tier: str
    fingerprint: str
    predicted_makespan: float            # simulate() seconds
    measured_seconds: float              # wall clock around the executor
    predicted_h2d_bytes: int = 0         # schedule-modeled transfer totals
    measured_h2d_bytes: int = 0          # executor byte counters
    predicted_d2h_bytes: int = 0
    measured_d2h_bytes: int = 0

    @property
    def key(self) -> DriftKey:
        return (self.kernel, self.tier, self.fingerprint)

    @property
    def time_ratio(self) -> float:
        return _ratio(self.measured_seconds, self.predicted_makespan)

    @property
    def byte_ratio(self) -> float:
        return _ratio(float(self.measured_h2d_bytes),
                      float(self.predicted_h2d_bytes))

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["time_ratio"] = self.time_ratio
        d["byte_ratio"] = self.byte_ratio
        return d


def key_str(key: DriftKey) -> str:
    return "|".join(key)


class DriftMonitor:
    """Rolling predicted-vs-measured monitor per (kernel, tier, fingerprint).

    ``window`` bounds the per-key rolling ratio; the full record list is
    capped at the oldest end so long services don't grow without bound.
    """

    def __init__(self, window: int = 32):
        self.window = window
        self._lock = threading.Lock()
        self._records: Deque[DriftRecord] = deque(maxlen=_MAX_RECORDS)
        self._ratios: Dict[DriftKey, Deque[float]] = {}
        # the key's first-ever ratio: the staleness baseline.  Kept outside
        # the rolling deque — once the window rolls, ``dq[0]`` is merely the
        # oldest *surviving* ratio and drifts along with the trend it is
        # supposed to detect.
        self._first: Dict[DriftKey, float] = {}

    # -- recording -----------------------------------------------------------
    def record(self, kernel: str, tier: str, fingerprint: str, *,
               predicted_makespan: float, measured_seconds: float,
               predicted_h2d_bytes: int = 0, measured_h2d_bytes: int = 0,
               predicted_d2h_bytes: int = 0,
               measured_d2h_bytes: int = 0) -> DriftRecord:
        rec = DriftRecord(
            kernel=kernel, tier=tier, fingerprint=fingerprint,
            predicted_makespan=float(predicted_makespan),
            measured_seconds=float(measured_seconds),
            predicted_h2d_bytes=int(predicted_h2d_bytes),
            measured_h2d_bytes=int(measured_h2d_bytes),
            predicted_d2h_bytes=int(predicted_d2h_bytes),
            measured_d2h_bytes=int(measured_d2h_bytes))
        with self._lock:
            self._records.append(rec)
            dq = self._ratios.get(rec.key)
            if dq is None:
                dq = self._ratios[rec.key] = deque(maxlen=self.window)
                self._first[rec.key] = rec.time_ratio
            dq.append(rec.time_ratio)
        return rec

    # -- introspection -------------------------------------------------------
    def records(self, kernel: Optional[str] = None) -> List[DriftRecord]:
        with self._lock:
            return [r for r in self._records
                    if kernel is None or r.kernel == kernel]

    def keys(self) -> List[DriftKey]:
        with self._lock:
            return sorted(self._ratios)

    def ratio(self, kernel: str, tier: str, fingerprint: str) -> float:
        """Rolling mean time ratio for one key (1.0 when never recorded)."""
        with self._lock:
            dq = self._ratios.get((kernel, tier, fingerprint))
            return sum(dq) / len(dq) if dq else 1.0

    def stale(self, threshold: float = 1.25) -> List[Tuple[DriftKey, float]]:
        """Keys whose rolling ratio left ``[1/threshold, threshold]`` —
        *relative to the key's own first-ever recorded ratio*, so a constant
        model-vs-wall scale (simulating a GPU on a CPU container) doesn't
        flag, but a trend away from the key's own history does.

        A key with a single observation is never stale: one sample has no
        trend (its ratio IS the baseline), and using the rolling window's
        head as the baseline would degenerate once the window rolls — the
        oldest surviving ratio tracks the drift instead of anchoring it.
        """
        out = []
        with self._lock:
            for key, dq in sorted(self._ratios.items()):
                if len(dq) < 2:
                    continue
                base = self._first.get(key, dq[0])
                cur = sum(dq) / len(dq)
                rel = _ratio(cur, base)
                if rel > threshold or rel < 1.0 / threshold:
                    out.append((key, rel))
        return out

    def snapshot(self) -> dict:
        """JSON document: every record plus per-key rolling summaries."""
        with self._lock:
            rolling = {}
            for key, dq in sorted(self._ratios.items()):
                rolling[key_str(key)] = {
                    "n": len(dq),
                    "mean_time_ratio": sum(dq) / len(dq),
                    "last_time_ratio": dq[-1],
                    "first_time_ratio": self._first.get(key, dq[0]),
                }
            return {
                "records": [r.to_json() for r in self._records],
                "rolling": rolling,
            }

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._ratios.clear()
            self._first.clear()
