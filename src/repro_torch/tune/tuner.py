"""AutoTuner — the closed loop: calibrate -> search -> cache -> execute.

Port of ``src/repro/tune/tuner.py``, held against it by
``tests/test_torch_tune.py``.  What the port adds is the calibrating
device: ``AutoTuner(torch_device=...)`` (default: the card; with no card
the caller passes ``torch_device="cpu"`` or injects both ``profile`` and
``fingerprint``) measures and fingerprints that device, lazily.

One object owns the three pieces: a :class:`~repro_torch.tune.calibrate.\
HardwareProfile` (measured lazily on first use, or injected for simulation
studies and tests), a :class:`~repro_torch.tune.cache.PlanCache`, and the
search options.  Entry points (``ooc_gemm(tune="auto")`` and friends) ask
it for a plan; repeat calls with the same problem and hardware fingerprint are
served from the cache without re-searching (``last_from_cache`` and the
``searches`` counter make that observable).

A module-level default tuner backs ``tune="auto"`` when the caller doesn't
supply one, so the calibration and cache warm-up cost is paid once per
process, not per call.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from repro_torch.obs import get_observability
from repro_torch.tune.cache import PlanCache
from repro_torch.tune.calibrate import (CalibrationResult, HardwareProfile,
                                        calibrate, hardware_fingerprint)
from repro_torch.tune.search import (TunedPlan, dtype_name, search_attention,
                                     search_factor, search_gemm)


class AutoTuner:
    """Plan factory for out-of-core kernels on the current hardware.

    Args:
      profile: engine model source; None measures the machine on first use.
      cache: plan store; None uses the default on-disk JSON cache.
      fingerprint: cache-key hardware identity; None derives it (from the
        calibration when one runs, else :func:`hardware_fingerprint`).
      tier: memory-tier name baked into cache keys ("HBM", "VMEM", ...).
      nstreams_options / nbuf_options / max_steps: search-space bounds.
      torch_device: the device calibrated and fingerprinted (default: the
        card; resolved when first needed).
    """

    def __init__(
        self,
        profile: Optional[HardwareProfile] = None,
        cache: Optional[PlanCache] = None,
        fingerprint: Optional[str] = None,
        tier: str = "HBM",
        nstreams_options: Sequence[int] = (1, 2),
        nbuf_options: Sequence[int] = (1, 2, 3),
        max_steps: int = 2048,
        torch_device=None,
    ):
        self.torch_device = torch_device
        self._profile = profile
        self._fingerprint = fingerprint
        self.cache = cache if cache is not None else PlanCache()
        self.tier = tier
        self.nstreams_options = tuple(nstreams_options)
        self.nbuf_options = tuple(nbuf_options)
        self.max_steps = max_steps
        self.calibration: Optional[CalibrationResult] = None
        self.searches = 0
        self.last_from_cache = False
        self._lock = threading.Lock()

    # -- lazy hardware identity --------------------------------------------
    @property
    def profile(self) -> HardwareProfile:
        with self._lock:
            if self._profile is None:
                self.calibration = calibrate(tier=self.tier,
                                             torch_device=self.torch_device)
                self._profile = self.calibration.profile
                if self._fingerprint is None:
                    self._fingerprint = self.calibration.fingerprint
            return self._profile

    @property
    def fingerprint(self) -> str:
        if self._fingerprint is None:
            self.profile  # calibration also fixes the fingerprint
            if self._fingerprint is None:
                self._fingerprint = hardware_fingerprint(self.torch_device)
        return self._fingerprint

    # -- plans --------------------------------------------------------------
    def _cached_plan(self, key: str, kernel: str, search) -> TunedPlan:
        """The one cache-or-search decision every plan method funnels
        through: a ``tune.plan`` span brackets the whole decision and a
        ``plancache.get`` span isolates the lookup, so a trace shows
        whether a run planned from cache or paid for a search."""
        obs = get_observability()
        with obs.span("tune.plan", cat="tune", kernel=kernel,
                      tier=self.tier) as sp:
            with obs.span("plancache.get", cat="tune", key=key):
                plan = self.cache.get(key)
            if plan is not None:
                self.last_from_cache = True
                sp.annotate(from_cache=True)
                return plan
            self.last_from_cache = False
            self.searches += 1
            plan = search()
            self.cache.put(key, plan)
            sp.annotate(from_cache=False, makespan=plan.makespan)
            return plan

    def gemm_plan(self, M: int, N: int, K: int, budget_bytes: int,
                  dtype: str = "float32", kernel: str = "gemm") -> TunedPlan:
        dtype = dtype_name(dtype)   # one spelling per dtype in cache keys
        key = PlanCache.key(kernel, (M, N, K), dtype, self.tier,
                            budget_bytes, self.fingerprint)
        return self._cached_plan(key, kernel, lambda: search_gemm(
            M, N, K, budget_bytes, self.profile,
            kernel=kernel, dtype=dtype, tier=self.tier,
            fingerprint=self.fingerprint,
            nstreams_options=self.nstreams_options,
            nbuf_options=self.nbuf_options,
            max_steps=self.max_steps))

    def syrk_plan(self, n: int, K: int, budget_bytes: int,
                  dtype: str = "float32") -> TunedPlan:
        return self.gemm_plan(n, n, K, budget_bytes, dtype=dtype,
                              kernel="syrk")

    def factor_plan(self, kind: str, n: int, panel: int, budget_bytes: int,
                    dtype: str = "float32") -> TunedPlan:
        """Whole-factorization plan (panel width, trailing block dims,
        streams/buffers, lookahead depth) for ``ooc_cholesky`` / ``ooc_lu``.

        One cache key — ``<kind>-factor:<n>x<panel>:...`` — covers every
        shrinking per-panel trailing shape, because the search simulates the
        complete multi-panel schedule rather than ranking each trailing
        SYRK/GEMM in isolation (the shrinking-dims path: a factorization
        would otherwise fill the cache with one entry per panel)."""
        dtype = dtype_name(dtype)
        key = PlanCache.key(f"{kind}-factor", (n, panel), dtype, self.tier,
                            budget_bytes, self.fingerprint)
        return self._cached_plan(key, f"{kind}-factor",
                                 lambda: search_factor(
            kind, n, panel, budget_bytes, self.profile,
            dtype=dtype, tier=self.tier, fingerprint=self.fingerprint,
            nstreams_options=self.nstreams_options,
            nbuf_options=self.nbuf_options,
            max_steps=max(self.max_steps, 4096)))

    def attention_plan(self, seq_len: int, kv_heads: int, head_dim: int,
                       q_heads: int, budget_bytes: int,
                       dtype: str = "float16") -> TunedPlan:
        dtype = dtype_name(dtype)
        key = PlanCache.key("attention", (seq_len, kv_heads, head_dim,
                                          q_heads), dtype, self.tier,
                            budget_bytes, self.fingerprint)
        return self._cached_plan(key, "attention",
                                 lambda: search_attention(
            seq_len, kv_heads, head_dim, q_heads, budget_bytes,
            self.profile,
            dtype=dtype, tier=self.tier,
            fingerprint=self.fingerprint,
            nstreams_options=self.nstreams_options,
            nbuf_options=tuple(nb for nb in self.nbuf_options if nb >= 2)
            or (2,),
            max_steps=max(self.max_steps, 4096)))


_default_tuner: Optional[AutoTuner] = None
_default_lock = threading.Lock()


def get_default_tuner() -> AutoTuner:
    """Process-wide tuner backing ``tune="auto"`` (calibrates the card
    lazily once; on a machine without one, install a tuner made with
    ``torch_device="cpu"`` through :func:`set_default_tuner`)."""
    global _default_tuner
    with _default_lock:
        if _default_tuner is None:
            _default_tuner = AutoTuner()
        return _default_tuner


def set_default_tuner(tuner: Optional[AutoTuner]) -> None:
    """Swap (or with None, reset) the process-wide default tuner."""
    global _default_tuner
    with _default_lock:
        _default_tuner = tuner
