"""Plan cache: search once per (problem, dtype, tier, hardware) tuple.

Port of ``src/repro/tune/cache.py``, held against it by
``tests/test_torch_tune.py`` and ``tests/test_torch_determinism.py``: the
same key format, ``SCHEMA_VERSION`` and atomic write.  The store is the
port's own (``$REPRO_TORCH_TUNE_CACHE``, else
``$XDG_CACHE_HOME/repro-torch-tune/plans.json`` or
``~/.cache/repro-torch-tune/plans.json``), so the two packages never
write one file.

Plans persist as one JSON document ``{"schema": N, "plans": {key: plan}}``
mapping cache keys to :meth:`~repro_torch.tune.search.TunedPlan.to_json`
payloads.  A store whose ``schema`` differs from :data:`SCHEMA_VERSION` is
treated as empty: bumping the version invalidates every cached plan at
once, which matters whenever the *search space* changes shape (v2 added
traversal-order and eviction-policy search — a v1 plan would silently pin
the old column-major-only schedule).  The key format (DESIGN.md §6) is::

    <kernel>:<problem dims 'x'-joined>:<dtype>:<tier>:<budget>:<fingerprint>

e.g. ``gemm:8192x8192x8192:float32:HBM:268435456:0f3a9c...`` — everything
the plan depends on and nothing it doesn't, so a repeat call on the same
machine is a hit while a different shape, dtype, memory tier, budget or
backend re-searches.  Writes are atomic (temp file + ``os.replace``) so a
crashed run never corrupts the store; a corrupt or unreadable store is
treated as empty rather than fatal (the cache is an accelerator, not a
dependency).  ``hits``/``misses`` counters make cache behavior assertable
in tests and visible in benchmarks.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Optional, Sequence

from repro_torch.obs import get_observability
from repro_torch.tune.search import TunedPlan

_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"

# bump whenever the planner's search space or TunedPlan semantics change in
# a way that makes previously-cached plans stale (v2: traversal x eviction
# joined the search space)
SCHEMA_VERSION = 2


def default_cache_path() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro-torch-tune", "plans.json")


class PlanCache:
    """JSON-file-backed store of :class:`TunedPlan` keyed by
    problem+hardware."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self.hits = 0
        self.misses = 0
        self._mem: Optional[Dict[str, dict]] = None
        # serializes load-modify-store within this instance; across
        # instances (or processes) the atomic os.replace below keeps the
        # store parseable — a racing writer can lose its update, never
        # corrupt the file
        self._lock = threading.Lock()

    @staticmethod
    def key(kernel: str, problem: Sequence[int], dtype: str, tier: str,
            budget: int, fingerprint: str) -> str:
        dims = "x".join(str(int(d)) for d in problem)
        return f"{kernel}:{dims}:{dtype}:{tier}:{int(budget)}:{fingerprint}"

    # -- storage ------------------------------------------------------------
    def _load(self) -> Dict[str, dict]:
        if self._mem is None:
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if (isinstance(data, dict)
                        and data.get("schema") == SCHEMA_VERSION
                        and isinstance(data.get("plans"), dict)):
                    self._mem = data["plans"]
                else:
                    # other schema versions (including the flat v1 layout)
                    # predate the current search space: invalidate wholesale
                    self._mem = {}
            except (OSError, ValueError):
                self._mem = {}
        return self._mem

    def _store(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": SCHEMA_VERSION, "plans": self._mem},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- API ----------------------------------------------------------------
    def get(self, key: str) -> Optional[TunedPlan]:
        m = get_observability().metrics
        with self._lock:           # counters update under the lock too, so
            raw = self._load().get(key)   # concurrent gets never lose a tick
            if raw is None:
                self.misses += 1
                m.counter("repro_plancache_misses_total",
                          "plan-cache lookups that re-search").inc()
                return None
            try:
                plan = TunedPlan.from_json(raw)
            except (TypeError, KeyError, ValueError):
                self.misses += 1   # schema drift: treat as miss, overwrite
                m.counter("repro_plancache_misses_total",
                          "plan-cache lookups that re-search").inc()
                m.counter("repro_plancache_schema_drift_total",
                          "cached plans rejected as unparseable").inc()
                return None
            self.hits += 1
            m.counter("repro_plancache_hits_total",
                      "plan-cache lookups served without a search").inc()
            return plan

    def put(self, key: str, plan: TunedPlan) -> None:
        with self._lock:
            self._load()[key] = plan.to_json()
            self._store()
        get_observability().metrics.counter(
            "repro_plancache_puts_total", "plans stored").inc()

    def clear(self) -> None:
        with self._lock:
            self._mem = {}
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._load())

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._load()
