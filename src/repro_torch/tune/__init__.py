"""repro_torch.tune — calibration-driven autotuning for the OOC engine.

Port of ``src/repro/tune/`` (ROADMAP module item 7), with the reference's
``__all__``; held against it by ``tests/test_torch_tune.py`` and
``tests/test_torch_determinism.py``, and on the card by ``chip_smoke.py``
(``[tune]`` lines).

The paper's numbers hinge on device-specific pipeline parameters (2 streams
on GPUs, 1 on Xeon Phi — claim C5; block shapes sized to each accelerator's
memory), yet hand-entered defaults travel badly.  This subsystem closes the
loop ``calibrate -> search -> cache -> execute``:

  * :mod:`repro_torch.tune.calibrate` — measure bandwidths/flops/
    overheads through the real ScheduleExecutor (CUDA events on the card);
    :class:`HardwareProfile` + fingerprint.
  * :mod:`repro_torch.tune.space` — feasible (partition, nstreams, nbuf,
    write-back) candidates, pruned by the nbuf-aware working-set model.
  * :mod:`repro_torch.tune.search` — rank candidates with ``simulate()`` as
    the cost oracle; returns a :class:`TunedPlan`.
  * :mod:`repro_torch.tune.cache` — JSON plan store keyed by
    (problem, dtype, tier, budget, hardware fingerprint).
  * :mod:`repro_torch.tune.tuner` — :class:`AutoTuner` facade wiring it
    all; backs ``ooc_gemm(tune="auto")`` and friends (``hclAutoTuner`` in
    ``core/api.py``).
"""

from repro_torch.tune.cache import PlanCache, default_cache_path
from repro_torch.tune.calibrate import (
    CalibrationResult,
    HardwareProfile,
    calibrate,
    gpu_profile,
    hardware_fingerprint,
    phi_profile,
    tpu_v5e_profile,
)
from repro_torch.tune.search import (TunedPlan, search_attention,
                                     search_factor, search_gemm)
from repro_torch.tune.space import (
    AttentionCandidate,
    GemmCandidate,
    attention_search_space,
    gemm_search_space,
)
from repro_torch.tune.tuner import (AutoTuner, get_default_tuner,
                                    set_default_tuner)

__all__ = [
    "AttentionCandidate", "AutoTuner", "CalibrationResult", "GemmCandidate",
    "HardwareProfile", "PlanCache", "TunedPlan", "attention_search_space",
    "calibrate", "default_cache_path", "gemm_search_space",
    "get_default_tuner", "gpu_profile", "hardware_fingerprint",
    "phi_profile", "search_attention", "search_factor", "search_gemm",
    "set_default_tuner", "tpu_v5e_profile",
]
