"""Deterministic fault injection + recovery for OOC schedules (§12).

Port of ``src/repro/fault/__init__.py``, a copy apart from its
imports, held against it by ``tests/test_torch_fault.py`` and
``tests/test_torch_fault_fuzz.py``.

The subsystem in one picture::

    plan  = FaultPlan.random(seed=7, sched=sched, rate=0.02)
    pol   = FaultPolicy(max_retries=3, backoff_base=0.01)
    ex.run(sched, operands, outputs, faults=plan, policy=pol)
    ex.last_fault_stats   # injected / retries / replayed_ops / bytes

Addressing (:mod:`.plan`), taxonomy (:mod:`.errors`), recovery knobs
(:mod:`.policy`) and offline redo-set analysis (:mod:`.replay`) are
separate modules; the executor hook itself lives in
``repro_torch.core.runtime`` and the oom/device_lost handlers in the entry
points that own the replanning paths.
"""

from repro_torch.fault.errors import (ComputeFault, DeviceLostError,
                                      ERROR_CLASSES, FaultError, OomError,
                                      TransferError)
from repro_torch.fault.plan import (FaultInjector, FaultPlan, FaultSpec,
                                    REPLAYABLE_KERNELS)
from repro_torch.fault.policy import DegradeStep, FaultPolicy
from repro_torch.fault.replay import mean_redo_len, redo_cost, redo_set

__all__ = [
    "ComputeFault", "DegradeStep", "DeviceLostError", "ERROR_CLASSES",
    "FaultError", "FaultInjector", "FaultPlan", "FaultPolicy", "FaultSpec",
    "OomError", "REPLAYABLE_KERNELS", "TransferError",
    "mean_redo_len", "redo_cost", "redo_set",
]
