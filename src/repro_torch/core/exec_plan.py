"""Port of ``src/repro/core/exec_plan.py`` (JAX-free), held against it by
``tests/test_torch_planning.py and tests/test_torch_executor.py``; a copy of the reference apart from its
imports. The late handler-registry import points at the
port's runtime.

ExecutablePlan — a :class:`~repro_torch.core.streams.Schedule` compiled for
dispatch (DESIGN.md §13).

``ScheduleExecutor.run`` used to pay per-op string/dict work on every run:
handler-registry lookups keyed by kernel name, payload ``isinstance``
dispatch, and (in concurrent mode) it would additionally need the event
graph rebuilt from scratch.  ``compile_executable`` hoists all of that into
a one-time compile step:

  * **handler resolution** — the registered callable per COMPUTE / finalize
    op, pre-fetched from the global registry (per-executor overrides are
    still consulted at run time; they are instance state, not schedule
    state);
  * **engine assignment** — every op is mapped to the engine that would run
    it on real hardware: one H2D copy engine, one D2H copy engine, one
    kernel engine per stream (the same engine split
    :func:`~repro_torch.core.simulator.gpu_like` models), with per-engine FIFO
    queues in issue order;
  * **dependency edges** — the direct happens-before edges of the event
    program (:func:`~repro_torch.core.streams.dependency_edges`, the same edges
    ``validate_schedule``'s vector clocks close over), plus *host-coherence
    edges* ordering an H2D re-read of an output operand after every earlier
    D2H that lands an overlapping host slice (the serial interpreter gets
    this from its pending-flush sweep; the concurrent runner gets it from
    these compile-time edges).  Edges within one engine are pruned — the
    engine's FIFO order implies them.

The compiled plan is cached **on the schedule object itself** (schedules
are mutable, unhashable dataclasses, so identity is the right cache key and
the plan dies with the schedule).  A cached plan is revalidated with an
O(n) identity scan over ``sched.ops`` — appending, replacing, or reordering
ops invalidates it — and against the handler-registry version, so
registering a new kernel handler recompiles affected plans instead of
serving stale resolutions.  Repeated runs of one schedule (tuner replays,
hybrid bands, fault replays, benchmark reps) therefore skip every per-op
string/dict step: ``plan_cache_stats()`` exposes the hit/miss counters the
``exec_plan_cache_hit`` benchmark row guards.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.streams import (BlockRef, Op, OpKind, Schedule, SliceRef,
                                dependency_edges)

# integer op-kind codes (faster to branch on than enum identity in the
# per-op hot path)
KIND_H2D = 0
KIND_COMPUTE = 1
KIND_D2H = 2

# fixed engine slots; compute engines follow at index 2 + stream
ENGINE_H2D = 0
ENGINE_D2H = 1

_CACHE_ATTR = "_exec_plan"

_stats_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0}


def plan_cache_stats() -> Dict[str, int]:
    """Process-wide plan-cache counters: ``{"hits": n, "misses": n}``."""
    with _stats_lock:
        return dict(_stats)


def reset_plan_cache_stats() -> None:
    with _stats_lock:
        _stats["hits"] = 0
        _stats["misses"] = 0


def _slices_may_overlap(a: SliceRef, b: SliceRef) -> bool:
    """Conservative host-span overlap test at compile time (no host shapes:
    a ``None`` extent means "the full axis" and overlaps everything)."""
    if a.operand != b.operand:
        return False

    def hit(sa: Optional[Tuple[int, int]], sb: Optional[Tuple[int, int]]
            ) -> bool:
        if sa is None or sb is None:
            return True
        return sa[0] < sb[0] + sb[1] and sb[0] < sa[0] + sa[1]

    return hit(a.rows, b.rows) and hit(a.cols, b.cols)


@dataclasses.dataclass
class ExecutablePlan:
    """Compiled, integer-indexed form of one schedule (see module doc).

    ``ops`` is an identity snapshot of ``sched.ops`` at compile time — the
    cache-validity witness *and* the object handlers receive (handlers take
    the full :class:`Op`, so the plan carries references, not copies).
    """

    sched: Schedule
    ops: List[Op]                       # snapshot, same objects as sched.ops
    n_ops: int
    kinds: List[int]                    # KIND_H2D / KIND_COMPUTE / KIND_D2H
    engines: List[str]                  # engine names, index = engine id
    engine_of: List[int]                # per-op engine id
    queues: List[List[int]]             # per-engine op indices, issue order
    preds: List[List[int]]              # cross-engine direct dependencies
    resolved: List[Optional[Callable]]  # registry handler per op (or None)
    kernels: List[Optional[str]]        # kernel name per handler op
    handlers_version: int               # registry version at compile time

    def is_valid_for(self, sched: Schedule, handlers_version: int) -> bool:
        ops = sched.ops
        if len(ops) != self.n_ops or handlers_version != self.handlers_version:
            return False
        mine = self.ops
        return all(mine[i] is ops[i] for i in range(self.n_ops))


def _compile(sched: Schedule, op_handlers: Dict[str, Callable],
             handlers_version: int) -> ExecutablePlan:
    ops = list(sched.ops)
    n = len(ops)
    n_streams = len(sched.streams)
    if ops:
        n_streams = max(n_streams, max(o.stream for o in ops) + 1)
    engines = ["h2d", "d2h"] + [f"compute:{s}" for s in range(n_streams)]

    kinds: List[int] = [0] * n
    engine_of: List[int] = [0] * n
    queues: List[List[int]] = [[] for _ in engines]
    resolved: List[Optional[Callable]] = [None] * n
    kernels: List[Optional[str]] = [None] * n

    _, preds = dependency_edges(sched)

    # D2H landing sites per output operand, for host-coherence edges
    d2h_slices: Dict[str, List[Tuple[int, SliceRef]]] = {}

    for i, op in enumerate(ops):
        ref = op.payload
        if op.kind == OpKind.H2D:
            kinds[i] = KIND_H2D
            engine_of[i] = ENGINE_H2D
        elif op.kind == OpKind.COMPUTE:
            kinds[i] = KIND_COMPUTE
            engine_of[i] = 2 + op.stream
            if isinstance(ref, BlockRef):
                kernels[i] = ref.kernel
                resolved[i] = op_handlers.get(ref.kernel)
        else:
            kinds[i] = KIND_D2H
            engine_of[i] = ENGINE_D2H
            if isinstance(ref, BlockRef):   # finalize handler
                kernels[i] = ref.kernel
                resolved[i] = op_handlers.get(ref.kernel)
            elif isinstance(ref, SliceRef):
                d2h_slices.setdefault(ref.operand, []).append((i, ref))
        queues[engine_of[i]].append(i)

    # host-coherence edges: an H2D whose source operand is also a D2H
    # target may read host bytes an earlier D2H writes (inout operands —
    # GEMM's C with beta != 0), so it must start after that D2H *lands*.
    # The event program orders the device buffers but not the host copy;
    # the serial interpreter flushes overlapping pending write-backs before
    # the read, the concurrent runner honors these explicit edges instead.
    for i, op in enumerate(ops):
        if kinds[i] != KIND_H2D or not isinstance(op.payload, SliceRef):
            continue
        sites = d2h_slices.get(op.payload.operand)
        if not sites:
            continue
        for j, jref in sites:
            if j < i and _slices_may_overlap(op.payload, jref):
                preds[i].append(j)

    # prune same-engine edges (the engine's FIFO walk implies them) and
    # duplicates; what remains is exactly the cross-engine wait set each
    # worker blocks on.
    pruned: List[List[int]] = []
    for i in range(n):
        e = engine_of[i]
        keep = sorted({j for j in preds[i] if engine_of[j] != e})
        pruned.append(keep)

    return ExecutablePlan(
        sched=sched, ops=ops, n_ops=n, kinds=kinds, engines=engines,
        engine_of=engine_of, queues=queues, preds=pruned,
        resolved=resolved, kernels=kernels,
        handlers_version=handlers_version)


def compile_executable(sched: Schedule) -> ExecutablePlan:
    """Compile ``sched`` into an :class:`ExecutablePlan`, served from the
    per-schedule cache when the op list and handler registry are unchanged
    since the last compile (see module doc for the invalidation rules)."""
    # late import: runtime owns the handler registry and imports this
    # module at load time, so the reference here must resolve lazily
    from repro_torch.core import runtime as _rt

    version = _rt.handlers_version()
    cached = getattr(sched, _CACHE_ATTR, None)
    if cached is not None and cached.is_valid_for(sched, version):
        with _stats_lock:
            _stats["hits"] += 1
        return cached
    with _stats_lock:
        _stats["misses"] += 1
    plan = _compile(sched, _rt._OP_HANDLERS, version)
    setattr(sched, _CACHE_ATTR, plan)
    return plan
