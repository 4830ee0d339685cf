"""repro_torch.hybrid — co-scheduling one OOC kernel across a device set.

Port of ``src/repro/hybrid/`` (ROADMAP module item 8), with the
reference's ``__all__``; held against it by ``tests/test_torch_hybrid.py``
and ``tests/test_torch_fault.py``, and on the card by ``chip_smoke.py``
(``[hybrid]`` lines).

The paper's title promises *hybrid computing platforms* (its testbeds pair
a GPU with a Xeon Phi in one node), but libhclooc only ever drives one
accelerator per kernel call.  This subsystem is the missing layer:

  * :mod:`repro_torch.hybrid.balance`  — functional-performance-model row
    split: shares sized so predicted per-device makespans equalize, with
    ``simulate()`` under each device's :class:`HardwareProfile` as the
    cost oracle and an iterative rebalance loop to a tolerance.
  * :mod:`repro_torch.hybrid.plan`     — :class:`HybridPlan`: per-device
    ``(GemmPartition, TunedPlan)`` pairs produced by reusing
    ``tune.search`` per sub-problem (the tuner IS the balance oracle, so
    the converged predictions are the plans' makespans).
  * :mod:`repro_torch.hybrid.executor` — concurrent execution of the
    per-device schedules through :class:`ScheduleExecutor`, exact merges
    (disjoint C bands; flash-attention partial combine),
    :func:`simulate_hybrid` aggregate prediction, Chrome traces with one
    lane-group per device, and the registered ``"HYBRID"``
    :class:`HybridOocRuntime` composite.

As in the reference, a member is a profile and a budget, not a place:
every member runs on the call's one torch device (``torch_device``,
default CUDA), each on an executor and CUDA streams of its own.

Entry points: ``ooc_gemm(..., devices=[...])`` (also ``ooc_syrk`` /
``ooc_attention`` / ``ooc_cholesky`` / ``ooc_lu``) and the
``hclHybridRuntime`` facade in ``core/api.py``.
"""

from repro_torch.hybrid.balance import (BalanceResult, DeviceSpec,
                                        balance_gemm, balance_units,
                                        gemm_cost_fn, surviving_devices)
from repro_torch.hybrid.executor import (HybridOocRuntime, HybridSimResult,
                                         device_schedule,
                                         merge_attention_partials,
                                         run_hybrid_attention,
                                         run_hybrid_gemm, run_hybrid_syrk,
                                         simulate_hybrid)
from repro_torch.hybrid.plan import (DevicePlan, HybridPlan,
                                     plan_hybrid_attention, plan_hybrid_gemm,
                                     plan_hybrid_syrk)

__all__ = [
    "BalanceResult", "DevicePlan", "DeviceSpec", "HybridOocRuntime",
    "HybridPlan", "HybridSimResult", "balance_gemm", "balance_units",
    "device_schedule", "gemm_cost_fn", "merge_attention_partials",
    "plan_hybrid_attention", "plan_hybrid_gemm", "plan_hybrid_syrk",
    "run_hybrid_attention", "run_hybrid_gemm", "run_hybrid_syrk",
    "simulate_hybrid", "surviving_devices",
]
