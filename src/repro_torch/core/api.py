"""hcl-prefixed facade — the paper's API surface over the port.

Port of ``src/repro/core/api.py`` for what this slice has: devices,
runtimes, streams, the partitioner, the pipeline compiler, the executor
and observability.  Tier sizes are the card's own
(:func:`~repro_torch.core.runtime.tier_bytes`): ``HBM`` is the device
memory, ``VMEM`` the shared memory a block may use.  Without a card the
caller passes ``mem_bytes``.  The hybrid, factorization, analysis, tuner
and fault facades arrive with their ROADMAP module items (8, 5, 9, 7, 6).
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core.exec_plan import ExecutablePlan, compile_executable
from repro_torch.core.partitioner import GemmPartition, plan_gemm_partition
from repro_torch.core.pipeline import PipelineSpec, compile_pipeline
from repro_torch.core.runtime import (NOT_PORTED, OocRuntime, RuntimeFactory,
                                      ScheduleExecutor, not_ported,
                                      register_op_handler, tier_bytes)
from repro_torch.core.streams import Device, Schedule, Stream, StreamFactory


class hclDeviceFactory:
    @staticmethod
    def create(name: str, dev_id: int = 0,
               mem_bytes: Optional[int] = None,
               torch_device=None) -> Device:
        """The hcl tier tuple; ``mem_bytes`` defaults to the card's size of
        the tier on ``torch_device``."""
        name = name.upper()
        if name in NOT_PORTED:
            raise not_ported(name)
        if name not in ("VMEM", "HBM"):
            raise ValueError(f"unknown device type {name!r}")
        return Device(name, dev_id,
                      mem_bytes or tier_bytes(name, torch_device))


class hclRuntimeFactory:
    @staticmethod
    def create(device: Device, **kw) -> OocRuntime:
        return RuntimeFactory.create(device, **kw)


class hclStreamFactory:
    @staticmethod
    def create(device: Device, n: int) -> List[Stream]:
        return StreamFactory.create(device, n)


def hclGetMemSize(device: Device) -> int:
    return device.mem_size()


def hclMatrixPartitioner(M: int, N: int, K: int, dMemSize: int,
                         bytes_per_el: int = 4,
                         nbuf: Optional[int] = None,
                         nstreams: Optional[int] = None) -> GemmPartition:
    """Partition against the device memory — optionally aware of the actual
    pipeline depth (``nbuf``/``nstreams``); default is the paper's fixed
    2-deep model."""
    return plan_gemm_partition(M, N, K, dMemSize, bytes_per_el,
                               nbuf=nbuf, nstreams=nstreams)


def hclCompilePipeline(spec: PipelineSpec, nstreams: int = 2,
                       nbuf: int = 2) -> Schedule:
    """DSL entry point: PipelineSpec -> event-correct Schedule."""
    return compile_pipeline(spec, nstreams=nstreams, nbuf=nbuf)


class hclScheduleExecutor(ScheduleExecutor):
    """Facade alias: the single schedule interpreter, with
    ``register_op_handler`` as the kernel extension point and
    ``mode="concurrent"`` issuing each engine's ops on its own CUDA
    stream."""


hclRegisterOpHandler = register_op_handler


def hclCompileExecutable(sched: Schedule) -> ExecutablePlan:
    """Compile (or fetch the cached) :class:`ExecutablePlan` for a schedule
    — pre-resolved handlers, per-engine queues, dependency edges."""
    return compile_executable(sched)


def hclObservability(enable: bool = False, trace: bool = False, **kw):
    """Facade over the process :class:`repro_torch.obs.Observability`
    bundle: metrics registry, tracer and drift monitor in one switch."""
    from repro_torch.obs import get_observability

    obs = get_observability()
    if enable or trace:
        obs.enable(metrics=True, trace=trace, **kw)
    return obs
