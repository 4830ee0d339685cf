"""Port of ``src/repro/core/simulator.py`` (JAX-free), held against it by
``tests/test_torch_planning.py``; a copy of the reference apart from its
imports. The TPU v5e engine models
(``tpu_v5e_vmem``/``tpu_v5e_ici``) are not carried over: the port holds no
TPU rates; parity tests build those models from the reference's values.

Discrete-event execution model for OOC schedules.

The paper's performance claims hinge on *overlap*: with two copy engines and a
kernel engine (NVIDIA GPUs), the 2-stream pipeline hides PCIe transfers behind
DGEMM; on Xeon Phi (shared engines, per-stream thread split) one stream is
optimal (claim C5); CUBLAS-XT's non-overlapping block schedule loses 2.3–4×
(claim C3).  This container has no PCIe bus or TPU, so we reproduce those
claims the way the schedules themselves predict them: a discrete-event
simulator with an explicit engine model, exercised by the *same* Schedule
objects the real runtimes execute.

Engine semantics follow CUDA stream rules:
  * ops within a stream start in order, each after the previous completes;
  * an op additionally waits for its events and for a free engine of its kind;
  * engines of a pool serve one op at a time at the pool's rate.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

from repro_torch.core.streams import Op, OpKind, Schedule


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Engine pools + rates. ``kind_pool`` maps op kind to a pool name."""

    name: str
    pools: Dict[str, int]                 # pool -> engine count
    kind_pool: Dict[OpKind, str]          # op kind -> pool
    h2d_bw: float                         # bytes/s
    d2h_bw: float
    flops: float                          # flop/s aggregate compute rate
    per_op_overhead: float = 2e-6         # s: launch/abstraction cost (C1)
    compute_split: int = 1                # engines sharing `flops` (Phi mode)
    # aggregate efficiency when the core's threads are split across streams
    # (paper §VI measures 549/725 ≈ 0.76 on Phi 3120P with 2 streams)
    split_efficiency: float = 1.0

    def duration(self, op: Op) -> float:
        if op.kind == OpKind.COMPUTE:
            rate = (self.flops * self.split_efficiency
                    / max(1, self.compute_split))
            return self.per_op_overhead + op.flops / rate
        bw = self.h2d_bw if op.kind == OpKind.H2D else self.d2h_bw
        return self.per_op_overhead + op.bytes / bw


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Expected-cost inflation for ranking plans under a fault rate
    (DESIGN.md §12).  Deterministic — no sampling — so tuner searches
    stay reproducible: each op's duration is replaced by its expectation
    under per-attempt fault probability ``rate``.

    Transfers retry until success: the expected attempt count is the
    geometric ``1/(1-rate)``, each failed attempt costing the transfer
    again plus ``mean_backoff`` sleep.  Computes recover by replay; a
    fault costs ``redo_factor`` op-durations of redone work on average
    (:func:`repro_torch.fault.replay.mean_redo_len` calibrates this per
    schedule; 1.0 is the no-chain floor).
    """

    rate: float
    mean_backoff: float = 0.0
    redo_factor: float = 1.0

    def expected_duration(self, op: Op, dur: float) -> float:
        r = min(max(self.rate, 0.0), 0.99)
        if r == 0.0:
            return dur
        if op.kind == OpKind.COMPUTE:
            return dur * (1.0 + r * self.redo_factor)
        retries = r / (1.0 - r)          # expected failed attempts
        return dur + retries * (dur + self.mean_backoff)


def gpu_like(flops: float = 1.16e12, pcie: float = 11e9) -> HardwareModel:
    """K40c-like: 2 independent copy engines + kernel engine (paper §I)."""
    return HardwareModel(
        name="gpu-like",
        pools={"h2d": 1, "d2h": 1, "exec": 1},
        kind_pool={OpKind.H2D: "h2d", OpKind.D2H: "d2h",
                   OpKind.COMPUTE: "exec"},
        h2d_bw=pcie, d2h_bw=pcie, flops=flops,
    )


def phi_like(flops: float = 0.725e12, pcie: float = 6.5e9,
             nstreams: int = 1) -> HardwareModel:
    """Xeon Phi 3120P-like: one shared transfer engine; offload streams split
    the core's threads, so ``nstreams`` compute engines each run at
    ``flops/nstreams`` (the paper's C5 observation)."""
    return HardwareModel(
        name="phi-like",
        pools={"xfer": 1, "exec": nstreams},
        kind_pool={OpKind.H2D: "xfer", OpKind.D2H: "xfer",
                   OpKind.COMPUTE: "exec"},
        h2d_bw=pcie, d2h_bw=pcie, flops=flops,
        compute_split=nstreams,
        split_efficiency=1.0 if nstreams == 1 else 0.76,
    )


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy: Dict[str, float]            # pool -> total busy seconds
    op_spans: List[Tuple[str, int, float, float]]  # (tag, stream, start, end)
    flops: int
    h2d_bytes: int
    d2h_bytes: int
    # H2D bytes actually moved, per operand class (from the H2D ops' parity
    # buffer keys) — exact, not modeled: the sum equals ``h2d_bytes``
    h2d_by_operand: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the schedule's block-cache counters (hits/misses/bytes per class)
    reuse: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)

    @property
    def effective_flops(self) -> float:
        return self.flops / self.makespan if self.makespan > 0 else 0.0

    @property
    def hit_rate(self) -> float:
        """Block-cache hit rate across all operand classes (0.0 when the
        schedule carries no residency stats)."""
        hits = sum(r["hits"] for r in self.reuse.values())
        total = hits + sum(r["misses"] for r in self.reuse.values())
        return hits / total if total else 0.0

    def utilization(self, pool: str) -> float:
        return self.busy.get(pool, 0.0) / self.makespan if self.makespan else 0.0

    def to_chrome_trace(self, process_name: str = "ooc-pipeline",
                        pid: int = 0) -> dict:
        """``chrome://tracing`` / Perfetto JSON for ``op_spans`` — one track
        per stream, so transfer/compute overlap is visually inspectable.
        ``pid`` places the spans in a specific lane group when several
        devices' results are merged into one trace."""
        from repro_torch.core.trace import chrome_trace
        return chrome_trace(self.op_spans, process_name=process_name, pid=pid,
                            reuse=self.reuse)


def _h2d_by_operand(sched: Schedule) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op in sched.ops:
        if op.kind == OpKind.H2D and op.buffers_written:
            key = op.buffers_written[0]
            name = key[0] if isinstance(key, tuple) else str(key)
            out[name] = out.get(name, 0) + op.bytes
    return out


def simulate(sched: Schedule, hw: HardwareModel,
             faults: "FaultModel" = None) -> SimResult:
    """Event-driven simulation of ``sched`` under ``hw``.

    ``faults`` switches on the faulted-makespan mode: every op duration
    becomes its expectation under the :class:`FaultModel`, so the tuner
    can rank candidate plans by expected cost at a given fault rate
    (``search_gemm(..., fault_rate=...)``).  ``faults=None`` is the exact
    fault-free model cross-checked against ``simulate_reference``.

    Deterministic greedy: repeatedly pick, among stream-head ops whose waited
    events are recorded, the op with the earliest feasible start (ties break
    to the lowest stream index).

    The ready queue is a lazy-key heap rather than a per-pick rescan of all
    stream heads, so large tuning sweeps stay fast.  A head enters the heap
    once all its waited events are recorded, keyed by its feasible start *at
    push time*; because every component of a feasible start (stream-free
    time, engine-free times, event times) only grows as ops are placed, a
    popped key is a lower bound — recompute, re-push if stale, place if
    exact.  The placed op's true start is then <= every other queued head's,
    which is exactly the scan's greedy choice (`simulate_reference`, the
    executable spec this is cross-checked against in
    ``benchmarks/bench_simulate.py``).
    """
    streams = sched.streams
    heads = [0] * len(streams)
    stream_free = [0.0] * len(streams)
    engine_free: Dict[str, List[float]] = {
        pool: [0.0] * n for pool, n in hw.pools.items()
    }
    event_time: Dict[str, float] = {}
    busy: Dict[str, float] = {pool: 0.0 for pool in hw.pools}
    spans: List[Tuple[str, int, float, float]] = []
    remaining = sum(len(s.ops) for s in streams)
    makespan = 0.0

    # (feasible-start lower bound, stream) heap + event -> blocked streams.
    ready: List[Tuple[float, int]] = []
    waiting: Dict[str, List[int]] = {}

    def feasible(si: int) -> Tuple[float, int, Op, str]:
        op = streams[si].ops[heads[si]]
        pool = hw.kind_pool[op.kind]
        free = engine_free[pool]
        if len(free) == 1:
            ei = 0
        else:
            ei = min(range(len(free)), key=free.__getitem__)
        start = stream_free[si]
        if free[ei] > start:
            start = free[ei]
        for ev in op.waits:
            t = event_time[ev.name]
            if t > start:
                start = t
        return start, ei, op, pool

    def enqueue(si: int) -> None:
        """Push stream ``si``'s head, or park it on its first missing event."""
        if heads[si] >= len(streams[si].ops):
            return
        op = streams[si].ops[heads[si]]
        for ev in op.waits:
            if ev.name not in event_time:
                waiting.setdefault(ev.name, []).append(si)
                return
        heapq.heappush(ready, (feasible(si)[0], si))

    for si in range(len(streams)):
        enqueue(si)

    while remaining:
        if not ready:
            raise RuntimeError(
                "simulator deadlock: no stream head is runnable "
                "(schedule should have failed validate_schedule)"
            )
        key, si = heapq.heappop(ready)
        start, ei, op, pool = feasible(si)
        if start > key:  # engine/event state moved since push: stale bound
            heapq.heappush(ready, (start, si))
            continue
        dur = hw.duration(op)
        if faults is not None:
            dur = faults.expected_duration(op, dur)
        end = start + dur
        engine_free[pool][ei] = end
        stream_free[si] = end
        busy[pool] += dur
        heads[si] += 1
        remaining -= 1
        makespan = max(makespan, end)
        spans.append((op.tag, si, start, end))
        if op.records is not None:
            event_time[op.records.name] = end
            for blocked in waiting.pop(op.records.name, ()):
                enqueue(blocked)
        enqueue(si)

    return SimResult(
        makespan=makespan,
        busy=busy,
        op_spans=spans,
        flops=sched.total_flops(),
        h2d_bytes=sched.total_bytes(OpKind.H2D),
        d2h_bytes=sched.total_bytes(OpKind.D2H),
        h2d_by_operand=_h2d_by_operand(sched),
        reuse={k: dict(v) for k, v in sched.reuse.items()},
    )


def simulate_reference(sched: Schedule, hw: HardwareModel) -> SimResult:
    """The original O(n_ops x n_streams) head-scan list scheduler.

    Kept as the executable specification of :func:`simulate`'s greedy rule:
    ``benchmarks/bench_simulate.py`` asserts span-for-span agreement, and the
    heap version's docstring argues equivalence against this loop.
    """
    streams = sched.streams
    heads = [0] * len(streams)
    stream_free = [0.0] * len(streams)
    engine_free: Dict[str, List[float]] = {
        pool: [0.0] * n for pool, n in hw.pools.items()
    }
    event_time: Dict[str, float] = {}
    busy: Dict[str, float] = {pool: 0.0 for pool in hw.pools}
    spans: List[Tuple[str, int, float, float]] = []
    remaining = sum(len(s.ops) for s in streams)
    makespan = 0.0

    while remaining:
        best = None  # (start, engine_idx, stream_idx, op)
        for si, st in enumerate(streams):
            if heads[si] >= len(st.ops):
                continue
            op = st.ops[heads[si]]
            if any(ev.name not in event_time for ev in op.waits):
                continue
            pool = hw.kind_pool[op.kind]
            ei = min(range(len(engine_free[pool])),
                     key=lambda k: engine_free[pool][k])
            start = max(
                stream_free[si],
                engine_free[pool][ei],
                max((event_time[ev.name] for ev in op.waits), default=0.0),
            )
            if best is None or start < best[0]:
                best = (start, ei, si, op)
        if best is None:
            raise RuntimeError(
                "simulator deadlock: no stream head is runnable "
                "(schedule should have failed validate_schedule)"
            )
        start, ei, si, op = best
        dur = hw.duration(op)
        end = start + dur
        pool = hw.kind_pool[op.kind]
        engine_free[pool][ei] = end
        stream_free[si] = end
        busy[pool] += dur
        heads[si] += 1
        remaining -= 1
        makespan = max(makespan, end)
        spans.append((op.tag, si, start, end))
        if op.records is not None:
            event_time[op.records.name] = end

    return SimResult(
        makespan=makespan,
        busy=busy,
        op_spans=spans,
        flops=sched.total_flops(),
        h2d_bytes=sched.total_bytes(OpKind.H2D),
        d2h_bytes=sched.total_bytes(OpKind.D2H),
        h2d_by_operand=_h2d_by_operand(sched),
        reuse={k: dict(v) for k, v in sched.reuse.items()},
    )
