"""Fault taxonomy for the injection + recovery subsystem (DESIGN.md §12).

Port of ``src/repro/fault/errors.py``, a copy apart from its
imports, held against it by ``tests/test_torch_fault.py`` and
``tests/test_torch_fault_fuzz.py``.

Four error classes cover the failure modes a long-running out-of-core
kernel meets in practice, each paired with the recovery action that is
actually sound for it:

  * ``TransferError``  ("h2d_error")  — a transient link failure on a
    host<->device transfer.  Recovery: per-op retry with exponential
    backoff; the op is idempotent (it re-reads host truth / re-lands the
    same in-flight block), so retrying is exact.
  * ``ComputeFault``   ("compute_nan") — a compute op produced garbage
    (NaNs from a soft error, a bad reduction, ...).  Recovery:
    block-granular replay from the block's last host-consistent point;
    the static schedule makes the redo-set exactly computable
    (:mod:`repro_torch.fault.replay`).
  * ``DeviceLostError`` ("device_lost") — the device is gone mid-run.
    Not recoverable inside one executor; the hybrid co-scheduler catches
    it, rebalances the lost share over the survivors and resumes.
  * ``OomError``        ("oom")        — the device ran out of memory.
    Not recoverable at the current plan; entry points catch it and walk
    the degradation ladder (halve nbuf, drop lookahead, halve budget)
    before recompiling.
"""

from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for every injected (or real) fault the subsystem models."""


class TransferError(FaultError):
    """Transient host<->device transfer failure — retryable."""


class ComputeFault(FaultError):
    """A compute op produced corrupt output — replayable at block grain."""


class DeviceLostError(FaultError):
    """The device disappeared mid-run — rebalance onto the survivors."""


class OomError(FaultError):
    """Device memory exhausted at the current plan — degrade and replan."""


# error-class string (the FaultSpec vocabulary) -> exception type
ERROR_CLASSES = {
    "h2d_error": TransferError,
    "compute_nan": ComputeFault,
    "device_lost": DeviceLostError,
    "oom": OomError,
}
