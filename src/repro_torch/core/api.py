"""hcl-prefixed facade — the paper's API surface over the port.

Port of ``src/repro/core/api.py`` for what this slice has: devices,
runtimes, streams, the partitioner, the pipeline compiler, the executor,
observability, the trace analysis, the factorizations, the fault policy
and the autotuner.  Tier sizes are the card's own
(:func:`~repro_torch.core.runtime.tier_bytes`): ``HBM`` is the device
memory, ``MESH`` the same per rank of the ring, ``VMEM`` the shared
memory a block may use.  Without a card the
caller passes ``mem_bytes``.  The ``HYBRID`` composite has no size of its
own: its placeholder reports 0, and the runtime made from it the sum of
its members' budgets.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core.exec_plan import ExecutablePlan, compile_executable
from repro_torch.core.partitioner import GemmPartition, plan_gemm_partition
from repro_torch.core.pipeline import PipelineSpec, compile_pipeline
from repro_torch.core.runtime import (OocRuntime, RuntimeFactory,
                                      ScheduleExecutor, register_op_handler,
                                      tier_bytes)
from repro_torch.core.streams import Device, Schedule, Stream, StreamFactory


class hclDeviceFactory:
    @staticmethod
    def create(name: str, dev_id: int = 0,
               mem_bytes: Optional[int] = None,
               torch_device=None) -> Device:
        """The hcl tier tuple; ``mem_bytes`` defaults to the card's size of
        the tier on ``torch_device`` (``MESH``: the card's memory, per
        rank; ``HYBRID``: 0, the composite's placeholder)."""
        name = name.upper()
        if name == "HYBRID":
            return Device(name, dev_id, mem_bytes or 0)
        if name not in ("VMEM", "HBM", "MESH"):
            raise ValueError(f"unknown device type {name!r}")
        return Device(name, dev_id,
                      mem_bytes or tier_bytes(name, torch_device))


class hclRuntimeFactory:
    @staticmethod
    def create(device: Device, mesh=None, **kw) -> OocRuntime:
        return RuntimeFactory.create(device, mesh, **kw)


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


def hclTraceAnalysis(sched: Schedule, hw=None, res=None, spans=None, **kw):
    """Facade over :class:`repro_torch.obs.analyze.TraceAnalysis`:
    bottleneck attribution over one schedule's span timeline.

        ana, res = hclTraceAnalysis(sched, hw=profile.model_for(2))
        print(ana.digest())        # verdict + critical-path shares
        ana.verify_reconciliation(res)   # exact accounting, or AssertionError

    Three input shapes: simulate here (``hw`` an engine model or a
    :class:`~repro_torch.tune.calibrate.HardwareProfile`, returns
    ``(analysis, SimResult)``), attribute an existing simulation (``res``),
    or attribute recorded spans (``spans``, e.g. an executor's
    ``last_spans``, tolerance-matched).  Resolved lazily: the analyzer
    imports the simulator."""
    from repro_torch.obs.analyze import TraceAnalysis

    if res is not None:
        return TraceAnalysis.from_sim(sched, res, hw=hw)
    if spans is not None:
        return TraceAnalysis.from_spans(sched, spans, hw=hw, **kw)
    if hw is None:
        raise ValueError("hclTraceAnalysis needs hw=, res= or spans=")
    if hasattr(hw, "model_for"):       # a HardwareProfile: default 2 streams
        hw = hw.model_for(kw.pop("nstreams", 2))
    return TraceAnalysis.analyze(sched, hw)


def hclHybridRuntime(devices, **kw):
    """Facade over :class:`repro_torch.hybrid.HybridOocRuntime` (DESIGN.md
    §7): one kernel call co-scheduled across a device set, load balanced
    by the members' profiles.

        gpu = DeviceSpec("gpu0", gpu_profile(), 2 * 2**30)
        phi = DeviceSpec("phi0", phi_profile(), 2 * 2**30)
        rt = hclHybridRuntime([gpu, phi])
        C = rt.gemm(A, B, C, alpha, beta)

    ``devices`` is a sequence of :class:`~repro_torch.hybrid.DeviceSpec`
    (or bare ``(name, profile, budget_bytes)`` tuples); every member runs
    on ``torch_device`` (default CUDA).  Resolved lazily —
    ``repro_torch.hybrid`` imports ``repro_torch.tune``, which imports this
    package."""
    from repro_torch.hybrid import HybridOocRuntime

    return HybridOocRuntime(devices, **kw)


def hclOocFactor(A, kind: str = "cholesky", **kw):
    """Facade over the out-of-core factorizations: one lookahead pipeline
    schedule interleaving panel POTRF/GETRF/TRSM ops with the streamed
    SYRK/GEMM trailing update.

        L = hclOocFactor(A, "cholesky", budget_bytes=..., lookahead=1)
        LU, perm = hclOocFactor(A, "lu", budget_bytes=...)

    Keyword arguments forward to :func:`repro_torch.core.ooc_factor.
    ooc_cholesky` / :func:`~repro_torch.core.ooc_factor.ooc_lu` (``panel``,
    ``budget_bytes``, ``lookahead``, ``torch_device``, ...).  The engine
    computes in float32 whatever the input dtype: float64 results carry
    f32-level residuals."""
    from repro_torch.core.ooc_factor import ooc_cholesky, ooc_lu

    if kind == "cholesky":
        return ooc_cholesky(A, **kw)
    if kind == "lu":
        return ooc_lu(A, **kw)
    raise ValueError(f"unknown factor kind {kind!r}; expected "
                     f"'cholesky' or 'lu'")


def hclAutoTuner(device: Optional[Device] = None, **kw):
    """Facade over :class:`repro_torch.tune.AutoTuner` (DESIGN.md §6):
    calibrate the card once, then dispense cached ``TunedPlan``s —
    partition geometry, stream count, buffer depth — per problem shape and
    tier.

        tuner = hclAutoTuner(device)                # calibrates lazily
        plan = tuner.gemm_plan(M, N, K, hclGetMemSize(device))
        C = ooc_gemm(A, B, budget_bytes=..., tune="auto", tuner=tuner)

    Keyword arguments forward to ``AutoTuner`` (``profile``, ``cache``,
    ``torch_device``, ...).  Resolved lazily: ``repro_torch.tune`` imports
    ``repro_torch.core`` submodules, so the facade must not import the
    tuner package at module load."""
    from repro_torch.tune import AutoTuner

    if device is not None:
        kw.setdefault("tier", device.name.upper())
    return AutoTuner(**kw)


def hclFaultPolicy(**kw):
    """Facade over :class:`repro_torch.fault.FaultPolicy` (DESIGN.md §12):
    the recovery knobs every resilient entry point shares — transfer retry
    count and exponential backoff, and the oom degrade ladder's depth.

        pol = hclFaultPolicy(max_retries=5, backoff_base=0.02)
        C = ooc_gemm(A, B, budget_bytes=..., faults=plan, fault_policy=pol)

    Pair with a :class:`~repro_torch.fault.FaultPlan` (deterministic,
    seeded, schedule-addressable) passed as ``faults=`` to ``ooc_gemm`` /
    ``ooc_syrk`` / ``ooc_cholesky`` / ``ooc_lu``."""
    from repro_torch.fault import FaultPolicy

    return FaultPolicy(**kw)
