"""MMOOC — out-of-core matrix multiplication, the paper's reference kernel.

Port of ``src/repro/core/oocgemm.py``, held against it by
``tests/test_torch_oocgemm.py`` and on the card by ``chip_smoke.py``.

``ooc_gemm`` plans a partition for the memory budget, builds the
event-correct pipeline schedule and executes it on the selected backend.
If the whole problem fits the budget, one in-core launch of the block GEMM
is issued instead (the paper's C2 transition).  Unlike the reference, whose
in-core path is XLA's dot, every path here runs the one hand-written
kernel, so the host, in-core and vmem results agree bit for bit.
Operands may be of any numeric dtype, as the reference's are: a mix, or
integers, is computed in float32 and cast to C's dtype (C defaults to
zeros of A's dtype); 64-bit operands land on the device in 32 bits.

``torch_device`` (default: CUDA) selects where blocks are computed; with
no card the caller must pass ``torch_device="cpu"`` (the kernels' plain
versions).  The host backend takes and returns host data (numpy arrays or
CPU tensors in, a CPU tensor out); the vmem backend moves its operands to
the device and returns a device tensor.  With no C an out-of-core host
call without faults makes C's blocks as zeros on the device (the
schedule's ``fill_c``: no host zero-fill, no H2D of C) and returns the
uninitialised output its write-backs cover; the in-core, vmem and
fault-armed paths run into zeros the call makes (``gemm.zero_c``).  A
caller's C is copied first and never written.

``faults=``/``fault_policy=`` (host backend) arm fault injection on the
executor (``repro_torch.fault``): transfer faults retry, compute faults
replay, and an injected oom in ``ooc_gemm`` walks the degrade ladder
(halve nbuf, then halve the budget; tuned runs halve the budget only,
each rung re-searched) and re-executes clean.

``tune="auto"`` (host backend) plans the partition, stream count, buffer
depth, traversal and eviction policy through an
:class:`~repro_torch.tune.AutoTuner` (``tuner=`` or the process default,
which calibrates the card), searched once per (shape, dtype, tier,
budget, hardware) and served from its plan cache after; a tuned run
records its measured wall and bytes against the plan's prediction
(``obs.record_drift``).

``devices=`` (a set of :class:`~repro_torch.hybrid.DeviceSpec`, or
``(name, profile, budget_bytes)`` tuples) co-executes the call across the
set (``repro_torch.hybrid``): C's rows are split so the members' profiles
predict equal finish times (``tolerance=`` overrides the balancer's 5 %),
each band runs on its member's executor, and every member computes on
``torch_device``.  The member budgets replace ``budget_bytes``.

``backend="mesh"`` runs the SUMMA ring of :class:`MeshOocRuntime` over
``mesh`` (a ``torch.distributed`` DeviceMesh with a ``"model"`` axis) or
a prepared ``runtime``; it returns C as a row-sharded DTensor.

Each call is one ``obs.call`` (``gemm``, ``syrk``): when the runtime's
executor records spans, or a tracer is active, its host work is recorded
by span (``gemm.intake``, ``gemm.plan``, ``gemm.zero_c`` where zeros are
made on the host or ``gemm.clone_c`` with a caller's C, ``gemm.execute``,
``gemm.drift``; ``syrk.*`` likewise) on ``get_observability().calls``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from repro_torch.core import pipeline as plib
from repro_torch.core.partitioner import GemmPartition, plan_gemm_partition
from repro_torch.core.runtime import (HostOocRuntime, MeshOocRuntime,
                                      OocRuntime, VmemOocRuntime, as_tensor,
                                      block_gemm, compute_dtype,
                                      device_tensor, host_tensor,
                                      resolve_device, zeros_c)
from repro_torch.core.streams import Device, OpKind, validate_schedule
from repro_torch.obs import get_observability


def is_in_core(M: int, N: int, K: int, budget_bytes: int,
               bytes_per_el: int = 4) -> bool:
    """True if A, B and C are simultaneously resident within the budget."""
    return (M * K + K * N + M * N) * bytes_per_el <= budget_bytes


def _check_slice(backend: str, tune, devices, faults,
                 backends=("host", "vmem")) -> None:
    if tune not in (None, "auto"):
        raise ValueError(f"unknown tune mode {tune!r}; expected None/'auto'")
    if faults is not None and (devices is not None or backend != "host"):
        raise ValueError("fault injection is supported on the host "
                         "pipeline backend only (hybrid paths take "
                         "fault_plans on run_hybrid_*)")
    if backend not in backends:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{backends}")


def _torch_device(runtime, torch_device) -> torch.device:
    """The device of a given runtime or executor (``torch_device``, if
    also given, must name it), else ``resolve_device(torch_device)``."""
    if runtime is None:
        return resolve_device(torch_device)
    if torch_device is not None \
            and resolve_device(torch_device) != runtime.torch_device:
        raise ValueError(f"torch_device {torch_device} differs from the "
                         f"runtime's {runtime.torch_device}")
    return runtime.torch_device


def _hybrid_kwargs(tolerance: Optional[float]) -> dict:
    return {} if tolerance is None else {"tolerance": tolerance}


def _tuned_gemm_plan(tuner, kernel: str, M: int, N: int, K: int,
                     budget_bytes: int, dtype):
    """Resolve the full :class:`~repro_torch.tune.TunedPlan` from the
    (default) autotuner's plan cache — searched once per (shape, dtype,
    tier, hardware).  Returning the plan (not just its pipeline knobs)
    keeps the predicted makespan available for drift recording."""
    from repro_torch.tune import get_default_tuner
    from repro_torch.tune.search import dtype_name

    if tuner is None:
        tuner = get_default_tuner()
    plan = tuner.gemm_plan(M, N, K, budget_bytes, dtype=dtype_name(dtype),
                           kernel=kernel)
    if not plan.write_back:
        # "keep"-mode plans describe resident-C (SUMMA-style) pipelines;
        # this entry point must land C in host memory
        raise ValueError(
            f"tuned plan for {kernel} {(M, N, K)} was searched with "
            f"write_back=False; ooc_{kernel} requires write-back plans")
    return plan


def _entry_call(entry: str):
    """Run the decorated entry point as ``obs.call(entry, record)``, where
    ``record`` is whether the caller's executor (``executor=``, or
    ``runtime=``'s) records spans."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            ex = kw.get("executor") \
                or getattr(kw.get("runtime"), "executor", None)
            with get_observability().call(
                    entry, getattr(ex, "record_spans", False)):
                return fn(*args, **kw)
        return call
    return deco


def _record_host_drift(plan, ex, sched, entry: str) -> None:
    """After a tuned run of ``sched`` on executor ``ex``: log measured
    wall/bytes against the plan's simulated makespan and the schedule's
    modeled byte totals (every tuned entry point's drift record), inside
    the span ``<entry>.drift``."""
    if plan is None:
        return
    obs = get_observability()
    with obs.span(f"{entry}.drift"):
        obs.record_drift(
            plan.kernel, plan.tier, plan.fingerprint,
            predicted_makespan=plan.makespan,
            measured_seconds=ex.last_wall_seconds,
            predicted_h2d_bytes=sched.total_bytes(OpKind.H2D),
            measured_h2d_bytes=ex.last_h2d_bytes,
            predicted_d2h_bytes=sched.total_bytes(OpKind.D2H),
            measured_d2h_bytes=ex.last_d2h_bytes)


def _operand(x, backend: str, dev: torch.device) -> torch.Tensor:
    return host_tensor(x) if backend == "host" else device_tensor(x, dev)


def _in_core(A, B, C, alpha, beta, backend: str, dev: torch.device
             ) -> torch.Tensor:
    """One resident launch of the block GEMM (claim C2 transition point)."""
    out = block_gemm(device_tensor(A, dev), device_tensor(B, dev),
                     device_tensor(C, dev), alpha=alpha, beta=beta)
    return out.cpu() if backend == "host" else out


def _host_gemm_resilient(rt, A, B, C, alpha, beta, part, sched, *, faults,
                         policy, tuned, tune, tuner, nstreams, nbuf,
                         traversal, evict, budget_bytes, bpe
                         ) -> torch.Tensor:
    """Host-backend GEMM under fault injection with the oom degrade ladder
    (DESIGN.md §12): an injected oom aborts the run, then halve-nbuf /
    halve-budget rungs replan, rebuild the schedule and re-execute clean
    (tuned runs: budget halvings only, each re-searched).  The attempted
    rungs are recorded in ``policy.degrades``."""
    from repro_torch.fault.errors import OomError
    from repro_torch.fault.policy import FaultPolicy

    M, K = A.shape
    N = B.shape[1]
    policy = policy or FaultPolicy()
    try:
        out = rt.gemm(A, B, C, alpha, beta, part, schedule=sched,
                      faults=faults, policy=policy)
        _record_host_drift(tuned, rt.executor, sched, "gemm")
        return out
    except OomError as e:
        # without its traceback, whose frames hold the failed run's device
        # buffers until the re-run would have ended
        oom = e.with_traceback(None)
    obs = get_observability()
    for step in policy.degrade_ladder(nbuf=nbuf, lookahead=0,
                                      budget_bytes=budget_bytes,
                                      tuned=tune == "auto"):
        policy.degrades.append(step)
        obs.instant(f"fault:degrade:{step.action}", kernel="gemm")
        try:
            if tune == "auto":
                t2 = _tuned_gemm_plan(tuner, "gemm", M, N, K,
                                      step.budget_bytes, A.dtype)
                part2, ns2, nb2 = (t2.gemm_partition(), t2.nstreams,
                                   t2.nbuf)
                tr2, ev2 = t2.traversal, t2.evict
            else:
                part2 = plan_gemm_partition(M, N, K, step.budget_bytes, bpe)
                ns2, nb2, tr2, ev2 = (nstreams, step.nbuf, traversal,
                                      evict)
            sched2 = plib.build_gemm_schedule(
                part2, nstreams=ns2, nbuf=nb2, traversal=tr2, evict=ev2)
            # clean re-run: the oom occurrence was consumed above
            out = rt.gemm(A, B, C, alpha, beta, part2, schedule=sched2)
        except ValueError:
            continue
        obs.record_fault_recovery("gemm", "degrade")
        return out
    raise oom


def _mesh_gemm(A, B, C, alpha, beta, mesh, runtime, budget_bytes):
    """The SUMMA ring over ``mesh`` (or a prepared ``runtime``'s)."""
    if runtime is None:
        if mesh is None:
            raise ValueError("backend='mesh' needs mesh= (a DeviceMesh) or "
                             "runtime= (a MeshOocRuntime)")
        runtime = MeshOocRuntime(mesh, device=Device("MESH", 0,
                                                     budget_bytes))
    if C is None:
        t = as_tensor(A)
        C = torch.zeros((t.shape[0], as_tensor(B).shape[1]),
                        dtype=compute_dtype(t.dtype))
        beta = 0.0
    return runtime.gemm(A, B, C, alpha, beta)


@_entry_call("gemm")
def ooc_gemm(
    A,
    B,
    C=None,
    alpha: float = 1.0,
    beta: float = 0.0,
    *,
    budget_bytes: int,
    backend: str = "host",
    nstreams: int = 2,
    nbuf: int = 2,
    traversal: str = "col",
    evict: str = "lru",
    validate: bool = False,
    runtime: Optional[OocRuntime] = None,
    tune: Optional[str] = None,
    tuner=None,
    devices: Optional[Sequence] = None,
    tolerance: Optional[float] = None,
    faults=None,
    fault_policy=None,
    torch_device=None,
    mesh=None,
) -> torch.Tensor:
    """Compute ``alpha * A @ B + beta * C`` streaming blocks through a memory
    tier of size ``budget_bytes``.

    backend: "host" (schedule-driven block streaming from host memory),
    "vmem" (one launch of the block GEMM on device-resident operands) or
    "mesh" (the SUMMA ring of :class:`MeshOocRuntime` over ``mesh``'s
    ``"model"`` axis, or over a prepared ``runtime``'s; every rank passes
    the full operands, or row/column-sharded DTensors, and gets C back as
    a row-sharded DTensor).

    traversal / evict (host backend): block-grid step order and
    residency-cache eviction policy — they change which H2D transfers the
    compiler's block cache elides, never the result.

    runtime: a prepared :class:`HostOocRuntime` / :class:`VmemOocRuntime`
    (for instance one whose executor runs ``mode="concurrent"``); its torch
    device is used.

    tune: ``None`` uses the defaults above; ``"auto"`` asks an
    :class:`~repro_torch.tune.AutoTuner` (``tuner`` or the process
    default) for a plan — partition geometry, stream count, buffer depth,
    traversal and eviction policy — served from its plan cache on repeat
    calls (host backend; the vmem backend plans its own launch).

    faults / fault_policy (host backend): a :class:`~repro_torch.fault.
    FaultPlan` (or ``sched -> plan`` callable) armed on the executor, with
    a :class:`~repro_torch.fault.FaultPolicy`.  Transfer faults retry,
    compute faults replay; an injected oom walks the degrade ladder (halve
    nbuf, then halve the budget; tuned runs halve the budget only, each
    rung re-searched) and re-executes clean.  The in-core path ignores
    them.

    devices: a set of :class:`~repro_torch.hybrid.DeviceSpec` (or ``(name,
    profile, budget_bytes)`` tuples) co-executes the GEMM across all of
    them, splitting C's rows so their profiles predict equal per-device
    finish times (``tolerance`` overrides the balancer default).  Budgets
    come from the specs, so ``budget_bytes`` is ignored on this path; host
    operands in, a CPU tensor out.
    """
    _check_slice(backend, tune, devices, faults,
                 ("host", "vmem", "mesh"))
    if backend == "mesh":
        return _mesh_gemm(A, B, C, alpha, beta, mesh, runtime, budget_bytes)
    dev = _torch_device(runtime, torch_device)
    if devices is not None:
        from repro_torch.hybrid import plan_hybrid_gemm, run_hybrid_gemm

        A = host_tensor(A)
        B = host_tensor(B)
        hplan = plan_hybrid_gemm(
            A.shape[0], B.shape[1], A.shape[1], devices, dtype=A.dtype,
            **_hybrid_kwargs(tolerance))
        out, _ = run_hybrid_gemm(A, B, C, alpha, beta, hplan,
                                 validate=validate, torch_device=dev)
        return out
    obs = get_observability()
    with obs.span("gemm.intake"):
        A = _operand(A, backend, dev)
        B = _operand(B, backend, dev)
    M, K = A.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"inner dims mismatch: {tuple(A.shape)} @ "
                         f"{tuple(B.shape)}")
    bpe = A.element_size()
    in_core = is_in_core(M, N, K, budget_bytes, bpe)
    if C is None:
        beta = 0.0
        if in_core or backend != "host":
            # else HostOocRuntime makes C: on the device (fill_c) or, with
            # faults armed, as host zeros it runs into, uncopied
            C = zeros_c("gemm", (M, N), A)

    if in_core:
        return _in_core(A, B, C, alpha, beta, backend, dev)

    tuned = None
    with obs.span("gemm.plan"):
        if tune == "auto" and backend == "host":
            tuned = _tuned_gemm_plan(tuner, "gemm", M, N, K, budget_bytes,
                                     A.dtype)
            part, nstreams, nbuf = (tuned.gemm_partition(), tuned.nstreams,
                                    tuned.nbuf)
            traversal, evict = tuned.traversal, tuned.evict
        else:
            part = plan_gemm_partition(M, N, K, budget_bytes, bpe)
        if backend == "host":
            # a fault-armed run keeps the reference's schedule, the ops its
            # fault plan and recovery counters are held to
            sched = plib.build_gemm_schedule(
                part, nstreams=nstreams, nbuf=nbuf, traversal=traversal,
                evict=evict, fill_c=C is None and faults is None)
            if validate:
                validate_schedule(sched)
    if backend == "host":
        rt = runtime or HostOocRuntime(Device("HBM", 0, budget_bytes),
                                       torch_device=dev)
        if faults is None:
            out = rt.gemm(A, B, C, alpha, beta, part, schedule=sched)
            _record_host_drift(tuned, rt.executor, sched, "gemm")
            return out
        return _host_gemm_resilient(
            rt, A, B, C, alpha, beta, part, sched, faults=faults,
            policy=fault_policy, tuned=tuned, tune=tune, tuner=tuner,
            nstreams=nstreams, nbuf=nbuf, traversal=traversal, evict=evict,
            budget_bytes=budget_bytes, bpe=bpe)
    rt = runtime or VmemOocRuntime(Device("VMEM", 0, budget_bytes),
                                   torch_device=dev)
    return rt.gemm(A, B, C, alpha, beta, part)


@_entry_call("syrk")
def ooc_syrk(
    P,
    C=None,
    alpha: float = 1.0,
    beta: float = 0.0,
    *,
    budget_bytes: int,
    backend: str = "host",
    nstreams: int = 2,
    nbuf: int = 2,
    traversal: str = "col",
    evict: str = "lru",
    validate: bool = False,
    runtime: Optional[OocRuntime] = None,
    tune: Optional[str] = None,
    tuner=None,
    devices: Optional[Sequence] = None,
    tolerance: Optional[float] = None,
    faults=None,
    fault_policy=None,
    torch_device=None,
) -> torch.Tensor:
    """Compute ``alpha * P @ P^T + beta * C`` out-of-core (blocked SYRK).

    On the host backend the SYRK pipeline spec streams the panel twice (row
    slices and transposed row slices) through the same schedule shape and
    ``dgemm`` handler as MMOOC; only individual blocks are transposed, on
    the host, into staging.  The vmem and in-core paths materialize
    ``P^T`` on the device and run the dense block GEMM.

    tune: as in :func:`ooc_gemm` — ``"auto"`` plans partition, streams,
    buffers, traversal and eviction through the autotuner (keyed as the
    ``syrk`` kernel, since the panel is streamed twice).

    faults / fault_policy: as in :func:`ooc_gemm`, without the degrade
    ladder (an injected oom raises, as in the reference).

    devices: as in :func:`ooc_gemm` — co-execute across a device set,
    splitting C's rows by profile (each band's transposed panel still
    streams the full P, block by block).
    """
    _check_slice(backend, tune, devices, faults)
    dev = _torch_device(runtime, torch_device)
    if devices is not None:
        from repro_torch.hybrid import plan_hybrid_syrk, run_hybrid_syrk

        P = host_tensor(P)
        hplan = plan_hybrid_syrk(P.shape[0], P.shape[1], devices,
                                 dtype=P.dtype, **_hybrid_kwargs(tolerance))
        out, _ = run_hybrid_syrk(P, C, alpha, beta, hplan,
                                 validate=validate, torch_device=dev)
        return out
    obs = get_observability()
    with obs.span("syrk.intake"):
        P = _operand(P, backend, dev)
    n, K = P.shape
    bpe = P.element_size()
    in_core = is_in_core(n, n, K, budget_bytes, bpe)
    if C is None:
        beta = 0.0
        if in_core or backend != "host":
            C = zeros_c("syrk", (n, n), P)

    if in_core:
        Pd = device_tensor(P, dev)
        return _in_core(Pd, Pd.T.contiguous(), C, alpha, beta, backend, dev)

    tuned = None
    with obs.span("syrk.plan"):
        if tune == "auto" and backend == "host":
            tuned = _tuned_gemm_plan(tuner, "syrk", n, n, K, budget_bytes,
                                     P.dtype)
            part, nstreams, nbuf = (tuned.gemm_partition(), tuned.nstreams,
                                    tuned.nbuf)
            traversal, evict = tuned.traversal, tuned.evict
        else:
            part = plan_gemm_partition(n, n, K, budget_bytes, bpe)
        if backend == "host":
            sched = plib.build_syrk_schedule(
                part, nstreams=nstreams, nbuf=nbuf, traversal=traversal,
                evict=evict)
            if validate:
                validate_schedule(sched)
    if backend == "host":
        rt = runtime or HostOocRuntime(Device("HBM", 0, budget_bytes),
                                       torch_device=dev)
        out = rt.syrk(P, C, alpha, beta, part, schedule=sched,
                      faults=faults, policy=fault_policy)
        _record_host_drift(tuned, rt.executor, sched, "syrk")
        return out
    rt = runtime or VmemOocRuntime(Device("VMEM", 0, budget_bytes),
                                   torch_device=dev)
    return rt.gemm(P, P.T.contiguous(), C, alpha, beta, part)


def plan_for_device(M: int, N: int, K: int, device: Device,
                    bytes_per_el: int = 4) -> GemmPartition:
    """Partition using the device's reported memory (hclGetMemSize path)."""
    return plan_gemm_partition(M, N, K, device.mem_bytes, bytes_per_el)
