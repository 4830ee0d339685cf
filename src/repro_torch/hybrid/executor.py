"""Co-execution: run per-device schedules concurrently, merge the results.

Each active device of a :class:`~repro_torch.hybrid.plan.HybridPlan` gets
its own compiled schedule (the *same* ``compile_pipeline`` output the
tuner ranked) and its own :class:`~repro_torch.core.runtime.
ScheduleExecutor`, driven from a thread pool.  Merging is kernel-specific
but always exact:

  * GEMM — devices own disjoint C row bands; each executor writes its band
    of the output tensor in place, so the merge is free.
  * SYRK — same row-band split; the transposed panel streams from the full
    host matrix (``syrk_pipeline_spec(pt_source=...)``) while each band's
    row slices stream from its own span.
  * attention — each device folds its KV chunk into an un-normalized
    online-softmax partial ``(m, l, acc)`` (the ``attn_partial`` finalize
    handler below); partials combine with the standard flash-attention
    merge, which is algebraically exact.

:func:`simulate_hybrid` predicts the co-executed makespan by simulating
every device's schedule under its own engine model — devices share nothing,
so the aggregate makespan is the slowest device's — and exports one
Chrome-trace lane-group per device (pid = device index).

Port of ``src/repro/hybrid/executor.py``, held against it by
``tests/test_torch_hybrid.py`` and ``tests/test_torch_fault.py``, and on
the card by ``chip_smoke.py`` (``[hybrid]`` lines).  As in the reference,
every member of the device set runs on the call's one torch device
(``torch_device``, default CUDA): members differ in their profile and
budget only, and two members on one card are two executors, each issuing
from its own pool thread onto its own CUDA streams.  What the port adds
for that:

  * Each member's executor is kept across calls, keyed by member name and
    torch device (:func:`_member`), with a CUDA stream of its own that the
    member's run takes as its current stream.  New streams would make the
    caching allocator call cudaMalloc with copies in flight (the stall
    ``ScheduleExecutor`` keeps its engine streams to avoid), and two runs
    on the one default stream would order each other's work.  Two calls
    naming the same member on one device take turns on it.
  * A member that raises (an injected ``device_lost``) has drained its
    streams before the executor re-raises, so no copy or kernel of the
    dead band is still in flight when its buffers are freed and the band
    is recomputed on the survivors.
  * The ``attn_partial`` carry is ``(1, H)``, ``(1, H)``, ``(1, H, d)``
    on the device (``core/ooc_attention.py``) and lands as the
    reference's ``(H,)``, ``(H,)``, ``(H, d)``; the merge runs in torch
    on those host tensors, in the reference's order of operations.

:func:`analyze_hybrid` attributes a plan's predicted co-execution, one
:class:`~repro_torch.obs.analyze.TraceAnalysis` per member, equal to the
reference's (``tests/test_torch_analyze.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.pipeline import (attention_pipeline_spec,
                                       compile_pipeline, gemm_pipeline_spec,
                                       syrk_pipeline_spec)
from repro_torch.core.runtime import (ExecState, OocRuntime,
                                      ScheduleExecutor, as_tensor,
                                      host_tensor, register_op_handler,
                                      register_runtime, resolve_device)
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.streams import (BlockRef, Device, Op, OpKind, Schedule,
                                      validate_schedule)
from repro_torch.core.trace import Span, chrome_trace_groups
from repro_torch.fault.errors import DeviceLostError
from repro_torch.hybrid.balance import DeviceSpec, surviving_devices
from repro_torch.hybrid.plan import (DevicePlan, HybridPlan, _as_device_specs,
                                     plan_hybrid_attention, plan_hybrid_gemm,
                                     plan_hybrid_syrk)
from repro_torch.obs import get_observability
from repro_torch.tune.search import dtype_name

# Host-operand name the SYRK transposed panel streams from in hybrid mode
# (each band's row slices stream from the band operand "P" instead).
_SYRK_FULL_PANEL = "Pfull"

SpanGroups = List[Tuple[str, List[Span]]]


@register_op_handler("attn_partial")
def _attn_partial_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """Finalize one device's KV chunk as an *un-normalized* partial: land
    the raw online-softmax carry (m, l, acc) in host buffers for the
    cross-device merge (contrast ``attn_out``, which normalizes), on the
    current stream."""
    for name, t in zip(("m", "l", "acc"), st.scratch["carry"]):
        dest = st.outputs[name]
        dest.copy_(t.reshape(dest.shape))


def merge_attention_partials(partials: Sequence[Tuple]) -> torch.Tensor:
    """Exact flash-attention combine of per-chunk (m, l, acc) partials
    (host tensors or numpy arrays: m, l (H,), acc (H, d))."""
    partials = [tuple(as_tensor(x) for x in p) for p in partials]
    m_star = torch.stack([m for m, _, _ in partials]).amax(dim=0)
    l_star = torch.zeros_like(partials[0][1])
    acc_star = torch.zeros_like(partials[0][2])
    for m, l, acc in partials:
        scale = torch.exp(m - m_star)
        l_star += l * scale
        acc_star += acc * scale[:, None]
    return acc_star / l_star[:, None]


def device_schedule(hplan: HybridPlan, dp: DevicePlan) -> Schedule:
    """Compile one device's sub-schedule — the identical spec/shape the
    tuner's search simulated, so executed and predicted pipelines agree."""
    plan = dp.plan
    if hplan.kernel == "gemm":
        if not plan.write_back:
            raise ValueError("hybrid GEMM requires write-back sub-plans")
        spec = gemm_pipeline_spec(plan.gemm_partition(),
                                  traversal=plan.traversal, band=plan.nbuf)
    elif hplan.kernel == "syrk":
        spec = syrk_pipeline_spec(plan.gemm_partition(),
                                  pt_source=_SYRK_FULL_PANEL,
                                  traversal=plan.traversal, band=plan.nbuf)
    elif hplan.kernel == "attention":
        _, kv_heads, head_dim, q_heads = plan.problem
        spec = attention_pipeline_spec(plan.attention_partition(),
                                       kv_heads, head_dim, q_heads)
        spec = dataclasses.replace(
            spec,
            writeback=dataclasses.replace(spec.writeback,
                                          kernel="attn_partial",
                                          out="partial"))
        return compile_pipeline(spec, nstreams=plan.nstreams, nbuf=plan.nbuf)
    else:
        raise ValueError(f"unknown hybrid kernel {hplan.kernel!r}")
    # gemm/syrk: replay the traversal + eviction policy the search ranked,
    # so each device's executed pipeline elides the same H2D transfers the
    # balancer's simulated makespans assumed
    return compile_pipeline(spec, nstreams=plan.nstreams, nbuf=plan.nbuf,
                            evict=plan.evict)


# One process-wide pool for device jobs, created on first multi-device run
# (constructing a fresh ThreadPoolExecutor per call cost thread spawns on
# every hybrid kernel invocation — tuner sweeps make thousands).  Jobs never
# submit nested jobs (the rebalance path re-enters run_hybrid_gemm from the
# *calling* thread after the pool drained), so a fixed-size pool cannot
# deadlock; excess jobs beyond the pool width simply queue.
_POOL_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None


def _shared_pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(4, os.cpu_count() or 1),
                thread_name_prefix="hybrid-device")
        return _POOL


def _run_concurrent(jobs) -> list:
    """Run one job per device on the shared pool (inline when there is only
    one: no pool overhead for the degenerate single-device plan)."""
    if len(jobs) == 1:
        return [jobs[0]()]
    pool = _shared_pool()
    return [f.result() for f in [pool.submit(j) for j in jobs]]


class _Member:
    """One member's executor on one torch device, kept across calls: its
    engine streams, pinned staging and (on a card) the stream its runs
    take as their current stream, so the caching allocator serves each
    run's buffers from blocks the member's earlier runs freed.  ``lock``
    makes two calls naming the same member take turns."""

    def __init__(self, name: str, dev: torch.device):
        self.executor = ScheduleExecutor(trace_group=name, mode="concurrent",
                                         torch_device=dev)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.lock = threading.Lock()

    def current(self):
        """The member's stream as the calling thread's current stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


_MEMBERS_LOCK = threading.Lock()
_MEMBERS: Dict[Tuple[str, torch.device], _Member] = {}


def _member(name: str, dev: torch.device) -> _Member:
    with _MEMBERS_LOCK:
        m = _MEMBERS.get((name, dev))
        if m is None:
            m = _MEMBERS[(name, dev)] = _Member(name, dev)
        return m


def _execute(hplan: HybridPlan, make_io, ctx: Dict,
             record_spans: bool,
             validate: bool,
             dev: torch.device,
             fault_plans: Optional[Dict] = None,
             fault_policy=None
             ) -> Tuple[SpanGroups, Dict[str, float], List[str]]:
    """Shared runner: per device, build (operands, outputs) via ``make_io``
    and run the compiled sub-schedule on the member's executor
    (:func:`_member`) on torch device ``dev``.

    Returns ``(span_groups, stats, lost)``; ``stats`` aggregates the
    measured executor byte counters and the schedules' modeled byte totals
    (equal by construction — the conformance tests pin it) plus per-device
    wall seconds (``device_walls``) and host staging seconds
    (``device_stage_seconds``).  When an obs tracer is active, spans
    are force-recorded so each device's pipeline lands in the trace as its
    own lane-group (the executor absorbs them under ``trace_group=device
    name``), and per-device lag is published as ``repro_hybrid_*``
    metrics.

    ``fault_plans`` maps device name -> FaultPlan (or schedule -> FaultPlan
    callable); each device's executor injects and recovers independently
    (DESIGN.md §12).  A ``device_lost`` fault kills only that device's job:
    its name lands in ``lost`` with zeroed counters, and the caller
    re-balances the band onto the survivors.  Other fault classes recover
    in-executor (retry / replay) and never surface here.
    """
    obs = get_observability()
    record = record_spans or obs.tracer is not None

    def job(dp: DevicePlan):
        sched = device_schedule(hplan, dp)
        if validate:
            validate_schedule(sched)
        # concurrent mode: each device's band genuinely overlaps its own
        # H2D/compute/D2H engines (an armed fault plan falls back to the
        # issue-order loop inside run())
        member = _member(dp.device.name, dev)
        operands, outputs = make_io(dp)
        faults = (fault_plans or {}).get(dp.device.name)
        with member.lock, member.current():
            ex = member.executor
            ex.record_spans = record
            t0 = time.perf_counter()
            try:
                ex.run(sched, operands=operands, outputs=outputs, ctx=ctx,
                       faults=faults, policy=fault_policy)
            except DeviceLostError:
                obs.instant("fault:device_lost_band", kernel=hplan.kernel,
                            device=dp.device.name)
                return {
                    "name": dp.device.name, "lost": True, "spans": [],
                    "wall": time.perf_counter() - t0, "stage": 0.0,
                    "h2d": 0, "d2h": 0, "sched_h2d": 0, "sched_d2h": 0,
                }
            return {
                "name": dp.device.name,
                "lost": False,
                "spans": list(ex.last_spans),
                "wall": time.perf_counter() - t0,
                "stage": ex.last_stage_seconds,
                "h2d": ex.last_h2d_bytes,
                "d2h": ex.last_d2h_bytes,
                "sched_h2d": sched.total_bytes(OpKind.H2D),
                "sched_d2h": sched.total_bytes(OpKind.D2H),
            }

    results = _run_concurrent([
        (lambda dp=dp: job(dp)) for dp in hplan.device_plans])
    lost = [r["name"] for r in results if r["lost"]]
    walls = [r["wall"] for r in results]
    stats = {
        "h2d_bytes": sum(r["h2d"] for r in results),
        "d2h_bytes": sum(r["d2h"] for r in results),
        "sched_h2d_bytes": sum(r["sched_h2d"] for r in results),
        "sched_d2h_bytes": sum(r["sched_d2h"] for r in results),
        "lag_seconds": max(walls) - min(walls),
        "wall_seconds": max(walls),
        "device_walls": {r["name"]: r["wall"] for r in results},
        "device_stage_seconds": {r["name"]: r["stage"] for r in results},
    }
    if obs.metrics.enabled:
        m = obs.metrics
        m.counter("repro_hybrid_runs_total",
                  "hybrid co-executions").inc(kernel=hplan.kernel)
        for r in results:
            m.gauge("repro_hybrid_device_wall_seconds",
                    "per-device wall seconds, last hybrid run").set(
                        r["wall"], kernel=hplan.kernel, device=r["name"])
        m.gauge("repro_hybrid_lag_seconds",
                "slowest-minus-fastest device wall, last hybrid run").set(
                    stats["lag_seconds"], kernel=hplan.kernel)
    groups = [(r["name"], r["spans"]) for r in results if not r["lost"]]
    return groups, stats, lost


_LAST = threading.local()


def last_run_stats() -> Dict[str, object]:
    """The calling thread's most recent ``run_hybrid_*`` call: measured
    (``h2d_bytes``, ``d2h_bytes``) and modeled (``sched_h2d_bytes``,
    ``sched_d2h_bytes``) bytes summed over the members, each member's wall
    (``device_walls``) and host staging fill (``device_stage_seconds``,
    on a card), ``lag_seconds``, ``wall_seconds``, the ``lost``
    members and, for each, its rebalance's stats and plan
    (``rebalanced``); attention adds the host merge's ``merge_seconds``.
    A lost member's bytes are counted as 0, as its drift record is
    skipped."""
    return getattr(_LAST, "stats", {})


def _set_last(stats: Dict, **kw) -> None:
    _LAST.stats = dict(stats, **kw)


def _record_hybrid_drift(obs, hplan: HybridPlan, wall_seconds: float,
                         stats: Dict[str, float]) -> None:
    """One drift record per hybrid run: the balancer's aggregate makespan
    prediction vs measured wall, and modeled vs measured byte totals (equal
    by construction).  Tier is ``HYBRID``; the device set stands in for the
    hardware fingerprint."""
    obs.record_drift(
        hplan.kernel, "HYBRID", "+".join(hplan.device_names()),
        predicted_makespan=hplan.predicted_makespan,
        measured_seconds=wall_seconds,
        predicted_h2d_bytes=int(stats["sched_h2d_bytes"]),
        measured_h2d_bytes=int(stats["h2d_bytes"]),
        predicted_d2h_bytes=int(stats["sched_d2h_bytes"]),
        measured_d2h_bytes=int(stats["d2h_bytes"]))


def _rebalance_lost_bands(kernel: str, hplan: HybridPlan,
                          lost: List[str], out: torch.Tensor,
                          C: torch.Tensor, alpha: float, beta: float,
                          band_operands, groups: SpanGroups, *,
                          record_spans: bool, validate: bool,
                          torch_device) -> List[Dict]:
    """Recompute every lost device's C row band on the survivors.

    Recovery is exact, not approximate: the band restarts from the
    ORIGINAL ``C[lo:hi]`` (the dead executor may have partially written
    ``out``'s band, but ``out`` is a copy so ``C`` is pristine), and the
    re-balanced sub-GEMM never splits K, so every C block is still one
    full-depth dot — bitwise identical to the fault-free run regardless of
    how the survivors' bands differ from the lost device's.  SYRK bands
    recover through the same path with ``B = P^T`` (identical operand bits
    into the identical dgemm kernel).  The recursive run is fault-free by
    construction: the ``device_lost`` occurrence was consumed by the dead
    job.  Survivors' spans gain a ``(rebalance <dead>)`` lane-group suffix.
    Returns each rebalance's stats, in order.
    """
    obs = get_observability()
    survivors = surviving_devices(
        [dp.device for dp in hplan.device_plans], lost)
    runs = []
    for dp in hplan.device_plans:
        if dp.device.name not in lost:
            continue
        lo, hi = dp.start, dp.start + dp.length
        a_band, b_full = band_operands(lo, hi)
        sub = plan_hybrid_gemm(
            dp.length, b_full.shape[1], a_band.shape[1], survivors,
            dtype=dtype_name(a_band.dtype))
        band, g2 = run_hybrid_gemm(
            a_band, b_full, C[lo:hi], alpha, beta, sub,
            record_spans=record_spans, validate=validate,
            torch_device=torch_device)
        runs.append(dict(last_run_stats(), device=dp.device.name,
                         plan=sub))
        out[lo:hi] = band
        groups.extend((f"{name} (rebalance {dp.device.name})", spans)
                      for name, spans in g2)
        obs.record_fault_recovery(kernel, "rebalance",
                                  device=dp.device.name)
    return runs


def _finish(kernel: str, hplan: HybridPlan, stats: Dict, lost: List[str],
            rebalanced: List[Dict], t0: float, obs) -> None:
    """Publish a GEMM/SYRK run's stats (:func:`last_run_stats`) and, when
    no device was lost, its drift record."""
    with obs.span("merge", cat="merge", kernel=kernel,
                  mode="in-place-bands"):
        pass  # disjoint C row bands: the merge is the writes themselves
    _set_last(stats, lost=lost, rebalanced=rebalanced)
    if not lost:
        _record_hybrid_drift(obs, hplan, time.perf_counter() - t0, stats)


def run_hybrid_gemm(A, B, C, alpha: float, beta: float, hplan: HybridPlan,
                    *, record_spans: bool = False,
                    validate: bool = False,
                    fault_plans: Optional[Dict] = None,
                    fault_policy=None,
                    torch_device=None) -> Tuple[torch.Tensor, SpanGroups]:
    """Co-execute ``alpha * A @ B + beta * C`` per the plan's row bands.

    Each device streams its band of A and C plus the whole B; bands are
    disjoint views of one output tensor, so the merge is the writes
    themselves.  Operands are host data (numpy arrays or CPU tensors);
    every member computes on ``torch_device`` (default CUDA).  Returns
    ``(C_out, [(device_name, spans), ...])`` with ``C_out`` a CPU tensor.

    ``fault_plans`` (device name -> FaultPlan) injects per-device faults:
    transfer/compute faults recover inside that device's executor; a
    ``device_lost`` fault drops the device and its band is re-balanced
    across the survivors and recomputed exactly (DESIGN.md §12).  The
    simulate-vs-actual drift record is skipped when a device was lost —
    the plan's predicted makespan no longer describes what ran.
    """
    dev = resolve_device(torch_device)
    A = host_tensor(A)
    B = host_tensor(B)
    M, K = A.shape
    _, N = B.shape
    if tuple(hplan.problem) != (M, N, K):
        raise ValueError(
            f"plan is for {hplan.problem}, operands are {(M, N, K)}")
    if C is None:
        C = torch.zeros((M, N), dtype=A.dtype)
        beta = 0.0
    C = host_tensor(C)
    out = C.clone()

    def make_io(dp: DevicePlan):
        lo, hi = dp.start, dp.start + dp.length
        return ({"A": A[lo:hi], "B": B}, {"C": out[lo:hi]})

    obs = get_observability()
    t0 = time.perf_counter()
    groups, stats, lost = _execute(
        hplan, make_io, {"alpha": alpha, "beta": beta}, record_spans,
        validate, dev, fault_plans=fault_plans, fault_policy=fault_policy)
    rebalanced = []
    if lost:
        rebalanced = _rebalance_lost_bands(
            "gemm", hplan, lost, out, C, alpha, beta,
            lambda lo, hi: (A[lo:hi], B), groups,
            record_spans=record_spans, validate=validate, torch_device=dev)
    _finish("gemm", hplan, stats, lost, rebalanced, t0, obs)
    return out, groups


def run_hybrid_syrk(P, C, alpha: float, beta: float, hplan: HybridPlan,
                    *, record_spans: bool = False,
                    validate: bool = False,
                    fault_plans: Optional[Dict] = None,
                    fault_policy=None,
                    torch_device=None) -> Tuple[torch.Tensor, SpanGroups]:
    """Co-execute ``alpha * P @ P^T + beta * C`` per the plan's row bands.

    ``fault_plans``/``fault_policy``/``torch_device`` behave as in
    :func:`run_hybrid_gemm`; a lost device's band re-balances as the
    equivalent GEMM with ``B = P^T`` (same operand bits, same dgemm kernel
    — bitwise).
    """
    dev = resolve_device(torch_device)
    P = host_tensor(P)
    n, K = P.shape
    if tuple(hplan.problem) != (n, n, K):
        raise ValueError(
            f"plan is for {hplan.problem}, panel is {(n, n, K)}")
    if C is None:
        C = torch.zeros((n, n), dtype=P.dtype)
        beta = 0.0
    C = host_tensor(C)
    out = C.clone()

    def make_io(dp: DevicePlan):
        lo, hi = dp.start, dp.start + dp.length
        return ({"P": P[lo:hi], _SYRK_FULL_PANEL: P}, {"C": out[lo:hi]})

    obs = get_observability()
    t0 = time.perf_counter()
    groups, stats, lost = _execute(
        hplan, make_io, {"alpha": alpha, "beta": beta}, record_spans,
        validate, dev, fault_plans=fault_plans, fault_policy=fault_policy)
    rebalanced = []
    if lost:
        Pt = P.T.contiguous()
        rebalanced = _rebalance_lost_bands(
            "syrk", hplan, lost, out, C, alpha, beta,
            lambda lo, hi: (P[lo:hi], Pt), groups,
            record_spans=record_spans, validate=validate, torch_device=dev)
    _finish("syrk", hplan, stats, lost, rebalanced, t0, obs)
    return out, groups


def run_hybrid_attention(q, k_cache, v_cache, hplan: HybridPlan,
                         *, record_spans: bool = False,
                         validate: bool = False,
                         torch_device=None
                         ) -> Tuple[torch.Tensor, SpanGroups]:
    """Co-execute decode attention: each device folds its KV chunk into a
    partial, merged exactly on the host.  Returns the f32 (H, d) output as
    a CPU tensor."""
    dev = resolve_device(torch_device)
    k_cache = host_tensor(k_cache)
    v_cache = host_tensor(v_cache)
    S, hkv, d = k_cache.shape
    q = as_tensor(q)
    H = q.shape[0]
    if tuple(hplan.problem) != (S, hkv, d, H):
        raise ValueError(
            f"plan is for {hplan.problem}, operands are {(S, hkv, d, H)}")
    parts: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def make_io(dp: DevicePlan):
        lo, hi = dp.start, dp.start + dp.length
        partial = (torch.zeros(H), torch.zeros(H), torch.zeros((H, d)))
        parts[dp.device.name] = partial
        return ({"K": k_cache[lo:hi], "V": v_cache[lo:hi]},
                {"m": partial[0], "l": partial[1], "acc": partial[2]})

    obs = get_observability()
    t0 = time.perf_counter()
    groups, stats, _ = _execute(
        hplan, make_io, {"q": q.to(device=dev, dtype=torch.float32)},
        record_spans, validate, dev)
    with obs.span("merge", cat="merge", kernel="attention",
                  mode="flash-partials",
                  n_partials=len(hplan.device_plans)):
        t_m = time.perf_counter()
        out = merge_attention_partials(
            [parts[dp.device.name] for dp in hplan.device_plans])
        merge_s = time.perf_counter() - t_m
    if obs.metrics.enabled:
        obs.metrics.gauge(
            "repro_hybrid_merge_seconds",
            "host-side partial-merge seconds, last hybrid run").set(
                merge_s, kernel="attention")
    _set_last(stats, lost=[], rebalanced=[], merge_seconds=merge_s)
    _record_hybrid_drift(obs, hplan, time.perf_counter() - t0, stats)
    return out, groups


# ===========================================================================
# Prediction
# ===========================================================================
@dataclasses.dataclass
class HybridSimResult:
    """Aggregate engine-model prediction for a co-executed plan."""

    makespan: float                                   # slowest device
    per_device: Tuple[Tuple[str, SimResult], ...]     # (name, SimResult)

    @property
    def device_makespans(self) -> Tuple[float, ...]:
        return tuple(r.makespan for _, r in self.per_device)

    def to_chrome_trace(self) -> dict:
        """One lane-group (trace process, pid = device index) per device."""
        return chrome_trace_groups(
            [(name, res.op_spans) for name, res in self.per_device])


def simulate_hybrid(hplan: HybridPlan) -> HybridSimResult:
    """Predict the co-executed makespan: simulate each device's compiled
    sub-schedule under its own ``profile.model_for(nstreams)``.  Devices
    share no engine, so they run truly concurrently and the aggregate
    makespan is the max — the number the reference's bench_hybrid holds
    against the best single-device tuned plan."""
    per = []
    for dp in hplan.device_plans:
        sched = device_schedule(hplan, dp)
        res = simulate(sched,
                       dp.device.profile.model_for(dp.plan.nstreams))
        per.append((dp.device.name, res))
    return HybridSimResult(
        makespan=max(r.makespan for _, r in per),
        per_device=tuple(per))


@dataclasses.dataclass
class HybridAnalysis:
    """Per-device bottleneck attribution for a co-executed plan.

    ``imbalance`` is ``(slowest - fastest) / slowest`` over the device
    makespans — the fraction of the critical device's time the other
    devices sit drained; the balancer's ``tolerance`` bounds it by
    construction.  Each device also carries its own
    :class:`~repro_torch.obs.analyze.TraceAnalysis`, so a lagging device's
    verdict (transfer- vs compute-bound) says *why* it lags.
    """

    makespan: float
    critical_device: str
    imbalance: float
    per_device: Tuple[Tuple[str, object], ...]    # (name, TraceAnalysis)

    def device(self, name: str):
        for n, ana in self.per_device:
            if n == name:
                return ana
        raise KeyError(name)

    def to_json(self) -> dict:
        return {
            "makespan_seconds": self.makespan,
            "critical_device": self.critical_device,
            "imbalance": self.imbalance,
            "devices": {name: ana.to_json(max_path=0)
                        for name, ana in self.per_device},
        }


def analyze_hybrid(hplan: HybridPlan,
                   sim: Optional[HybridSimResult] = None) -> HybridAnalysis:
    """Attribute a hybrid plan's predicted co-execution: one exact
    :class:`~repro_torch.obs.analyze.TraceAnalysis` per device (same recompiled
    schedule + engine model as :func:`simulate_hybrid`), plus the
    cross-device imbalance.  Publishes ``repro_analysis_*`` metrics (one
    ``kernel=<kernel>:<device>`` series per device) when obs is enabled.
    """
    from repro_torch.obs.analyze import TraceAnalysis

    sim = sim or simulate_hybrid(hplan)
    obs = get_observability()
    per = []
    for dp, (name, res) in zip(hplan.device_plans, sim.per_device):
        sched = device_schedule(hplan, dp)
        hw = dp.device.profile.model_for(dp.plan.nstreams)
        ana = TraceAnalysis.from_sim(sched, res, hw=hw)
        obs.record_analysis(ana, kernel=f"{hplan.kernel}:{name}")
        per.append((name, ana))
    spans = sim.device_makespans
    imbalance = (max(spans) - min(spans)) / max(spans) if max(spans) else 0.0
    critical = max(sim.per_device, key=lambda nr: nr[1].makespan)[0]
    if obs.metrics.enabled:
        obs.metrics.gauge(
            "repro_analysis_hybrid_imbalance_ratio",
            "(slowest - fastest) / slowest device makespan, last plan").set(
                imbalance, kernel=hplan.kernel)
    return HybridAnalysis(makespan=sim.makespan, critical_device=critical,
                          imbalance=imbalance, per_device=tuple(per))


# ===========================================================================
# The composite runtime (registered tier "HYBRID")
# ===========================================================================
@register_runtime("HYBRID")
class HybridOocRuntime(OocRuntime):
    """``hclRuntime`` composite: one kernel call, a set of devices.

    Construct with the device set (plus optional planning knobs); every
    kernel call balances, tunes and co-executes, caching nothing across
    calls except what ``plan_hybrid_*`` memoizes internally and the
    members' executors (:func:`_member`).  ``last_plan`` and
    ``last_span_groups`` expose the most recent plan and (when
    ``record_spans=True``) the per-device spans for tracing.  Every member
    runs on ``torch_device`` (default CUDA).
    """

    def __init__(self, devices: Sequence[Union[DeviceSpec, Tuple]],
                 device: Optional[Device] = None,
                 tolerance: float = 0.05,
                 max_iters: int = 16,
                 nstreams_options: Sequence[int] = (1, 2),
                 nbuf_options: Sequence[int] = (1, 2, 3),
                 max_steps: int = 2048,
                 torch_device=None):
        self.devices = _as_device_specs(devices)
        self.torch_device = resolve_device(torch_device)
        self.device = device or Device(
            "HYBRID", 0, sum(d.budget_bytes for d in self.devices))
        self.plan_opts = dict(
            tolerance=tolerance, max_iters=max_iters,
            nstreams_options=tuple(nstreams_options),
            nbuf_options=tuple(nbuf_options), max_steps=max_steps)
        self.last_plan: Optional[HybridPlan] = None
        self.last_span_groups: SpanGroups = []

    @classmethod
    def from_device(cls, device: Device, *, devices=None, mesh=None,
                    **kw) -> "HybridOocRuntime":
        if not devices:
            raise ValueError(
                "HYBRID runtime needs devices=[DeviceSpec, ...] "
                "(name, profile, budget_bytes per member)")
        specs = _as_device_specs(devices)
        if device.mem_bytes <= 0:
            # hclDeviceFactory's HYBRID placeholder carries no size of its
            # own: the composite's memory is the member budgets' sum
            device = dataclasses.replace(
                device, mem_bytes=sum(d.budget_bytes for d in specs))
        return cls(specs, device=device, **kw)

    def gemm(self, A, B, C, alpha: float, beta: float, part=None,
             plan: Optional[HybridPlan] = None,
             record_spans: bool = False,
             fault_plans: Optional[Dict] = None,
             fault_policy=None, **kw) -> torch.Tensor:
        A = host_tensor(A)
        B = host_tensor(B)
        plan = plan or plan_hybrid_gemm(
            A.shape[0], B.shape[1], A.shape[1], self.devices,
            dtype=A.dtype, **self.plan_opts)
        self.last_plan = plan
        out, self.last_span_groups = run_hybrid_gemm(
            A, B, C, alpha, beta, plan, record_spans=record_spans,
            fault_plans=fault_plans, fault_policy=fault_policy,
            torch_device=self.torch_device)
        return out

    def syrk(self, P, C, alpha: float, beta: float, part=None,
             plan: Optional[HybridPlan] = None,
             record_spans: bool = False,
             fault_plans: Optional[Dict] = None,
             fault_policy=None, **kw) -> torch.Tensor:
        P = host_tensor(P)
        plan = plan or plan_hybrid_syrk(
            P.shape[0], P.shape[1], self.devices,
            dtype=P.dtype, **self.plan_opts)
        self.last_plan = plan
        out, self.last_span_groups = run_hybrid_syrk(
            P, C, alpha, beta, plan, record_spans=record_spans,
            fault_plans=fault_plans, fault_policy=fault_policy,
            torch_device=self.torch_device)
        return out

    def attention(self, q, k_cache, v_cache,
                  plan: Optional[HybridPlan] = None,
                  record_spans: bool = False, **kw) -> torch.Tensor:
        k_cache = host_tensor(k_cache)
        S, hkv, d = k_cache.shape
        opts = dict(self.plan_opts)
        opts["nbuf_options"] = tuple(
            nb for nb in opts["nbuf_options"] if nb >= 2) or (2,)
        opts["max_steps"] = max(opts["max_steps"], 4096)
        plan = plan or plan_hybrid_attention(
            S, hkv, d, as_tensor(q).shape[0], self.devices,
            dtype=k_cache.dtype, **opts)
        self.last_plan = plan
        out, self.last_span_groups = run_hybrid_attention(
            q, k_cache, v_cache, plan, record_spans=record_spans,
            torch_device=self.torch_device)
        return out
