"""Port of ``src/repro/core/streams.py`` (JAX-free), held against it by
``tests/test_torch_planning.py``; a copy of the reference apart from its
imports.

Unified Device / Stream / Event abstractions — libhclooc's core interface.

The paper unifies CUDA streams+events, Intel offload streams+signals, and
OpenCL command queues behind ``hclStream``/``hclEvent`` data containers plus an
``hclRuntime`` that issues async ops onto streams.  On TPU the analogous
"queues" are the pipeline slots of the double-buffered DMA engine (``vmem``
backend), the async-dispatch queue (``host`` backend), and the ping-pong
``collective_permute`` buffers of a SUMMA ring (``mesh`` backend).

These classes carry *schedule structure* (issue order, dependency edges,
buffer parity).  Execution semantics are supplied by:

  * ``core.simulator`` — a discrete-event hardware model (copy engines ×
    kernel engine) that turns a schedule into a makespan; used to reproduce
    the paper's overlap claims (C3, C5) without a PCIe bus to measure.
  * ``core.runtime`` — real JAX executors where an Event resolves to a data
    dependency (the consuming op takes the produced array as an operand; value
    dependence on an SSA array IS the event graph on TPU).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Hashable, List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Device:
    """The paper's ``{name, id}`` tuple plus ``hclGetMemSize``.

    ``name`` selects the backend/tier: "VMEM", "HBM", "MESH" (TPU tiers) —
    the analogues of the paper's "GPU"/"PHI"/"FPGA".
    """

    name: str
    id: int
    mem_bytes: int

    def mem_size(self) -> int:  # hclGetMemSize
        return self.mem_bytes


class OpKind(enum.Enum):
    H2D = "H2D"          # backing tier -> fast tier (paper: host to device)
    D2H = "D2H"          # fast tier -> backing tier
    COMPUTE = "COMPUTE"  # in-core kernel on resident blocks (paper: DGEMM)


@dataclasses.dataclass(frozen=True)
class SliceRef:
    """Typed transfer payload: which host-side slice an H2D/D2H op moves.

    ``operand`` names a streamed operand class (the key the executor uses to
    look up the host array); ``index`` is the operand's block number; ``rows``
    and ``cols`` are ``(start, size)`` half-open slices (None = full extent);
    ``transpose`` transposes the slice after extraction (SYRK streams the same
    panel as both the row and the transposed column operand).
    """

    operand: str
    index: int
    rows: Optional[Tuple[int, int]] = None
    cols: Optional[Tuple[int, int]] = None
    transpose: bool = False


@dataclasses.dataclass(frozen=True)
class BlockRef:
    """Typed compute/finalize payload: which registered kernel handler runs.

    ``kernel`` is the key into the :class:`~repro_torch.core.runtime.ScheduleExecutor`
    handler registry ("dgemm", "attn", "noop", ...); ``index`` is the pipeline
    step.  Buffer operands are carried by the op's ``buffers_read`` /
    ``buffers_written`` in the spec's declared order, so handlers are
    positional — no raw dict spelunking.
    """

    kernel: str
    index: int


Payload = Union[SliceRef, BlockRef]


@dataclasses.dataclass(frozen=True)
class Event:
    """Named completion marker (``hclEvent``).

    The paper's events are created uninitialised and recorded by the async op
    they are passed to; here an Event is identified by name and recorded by
    exactly one Op.
    """

    name: str


@dataclasses.dataclass(frozen=True)
class Op:
    """One asynchronous command issued to a stream (``hclMemcpyAsync`` /
    ``hclDgemmAsync`` analogue).

    Attributes:
      kind: transfer direction or compute.
      tag: human-readable, e.g. "S(a[3])", "DGEMM[3]", "R(c[3])".
      stream: stream index the op is enqueued on.
      waits: events that must be recorded before this op may *start*
             (``hclWaitEvent`` semantics: blocks the stream, not the host).
      records: event recorded when this op completes (or None).
      buffers_read / buffers_written: abstract buffer ids touched — used by
             the validator to prove the schedule never overwrites live data
             (the paper's stated purpose for its five event sets).
      bytes: payload for transfers (drives the simulator's bandwidth model).
      flops: work for compute ops (drives the simulator's compute model).
    """

    kind: OpKind
    tag: str
    stream: int
    waits: Tuple[Event, ...] = ()
    records: Optional[Event] = None
    buffers_read: Tuple[Hashable, ...] = ()
    buffers_written: Tuple[Hashable, ...] = ()
    bytes: int = 0
    flops: int = 0
    payload: Optional[Payload] = None  # typed SliceRef / BlockRef


@dataclasses.dataclass
class Stream:
    """An ordered queue of Ops bound to a Device (``hclStream``)."""

    device: Device
    index: int
    ops: List[Op] = dataclasses.field(default_factory=list)

    def enqueue(self, op: Op) -> None:
        assert op.stream == self.index, (op.stream, self.index)
        self.ops.append(op)


class StreamFactory:
    """``hclStreamFactory``: create N streams for a device."""

    @staticmethod
    def create(device: Device, n: int) -> List[Stream]:
        if n < 1:
            raise ValueError("need at least one stream")
        return [Stream(device, i) for i in range(n)]


@dataclasses.dataclass
class Schedule:
    """A complete multi-stream program: the object the paper writes by hand in
    Fig. 2 and that our ``pipeline.PipelineSpec`` DSL generates."""

    device: Device
    streams: List[Stream]
    ops: List[Op] = dataclasses.field(default_factory=list)  # global issue order
    # residency stats per operand class (hits/misses/bytes_moved/bytes_saved)
    # filled by the pipeline compiler's block cache; empty for hand-built
    # schedules
    reuse: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    # compile-time knobs worth reporting (traversal, eviction policy, ...)
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)

    def issue(self, op: Op) -> Op:
        self.ops.append(op)
        self.streams[op.stream].enqueue(op)
        return op

    # -- introspection used by benchmarks ------------------------------------
    def total_bytes(self, kind: OpKind) -> int:
        return sum(o.bytes for o in self.ops if o.kind == kind)

    def total_flops(self) -> int:
        return sum(o.flops for o in self.ops if o.kind == OpKind.COMPUTE)


class ScheduleError(AssertionError):
    pass


def dependency_edges(sched: Schedule
                     ) -> Tuple[Dict[str, int], List[List[int]]]:
    """Direct happens-before edges of the event program.

    Returns ``(recorder, preds)``: ``recorder`` maps event name -> issue
    index of the op that records it, ``preds[i]`` lists the issue indices
    op ``i`` directly depends on — its stream predecessor plus the recorder
    of every event it waits on.  The transitive closure of these edges IS
    the schedule's happens-before relation; :func:`validate_schedule`
    layers vector clocks on top of them and
    :func:`repro_torch.core.exec_plan.compile_executable` turns them into the
    concurrent executor's ``threading.Event`` program.

    Raises :class:`ScheduleError` on a twice-recorded event or a wait on a
    never-recorded event (both make the edge list meaningless).
    """
    ops = sched.ops
    n = len(ops)
    recorder: Dict[str, int] = {}
    for idx, op in enumerate(ops):
        if op.records is not None:
            if op.records.name in recorder:
                raise ScheduleError(f"event {op.records.name} recorded twice")
            recorder[op.records.name] = idx

    preds: List[List[int]] = [[] for _ in range(n)]
    last_in_stream: Dict[int, int] = {}
    for idx, op in enumerate(ops):
        if op.stream in last_in_stream:
            preds[idx].append(last_in_stream[op.stream])
        last_in_stream[op.stream] = idx
        for ev in op.waits:
            if ev.name not in recorder:
                raise ScheduleError(
                    f"op {op.tag} waits on never-recorded event {ev.name}"
                )
            preds[idx].append(recorder[ev.name])
    return recorder, preds


def validate_schedule(sched: Schedule) -> None:
    """Prove the event graph is correct — the property the paper's five event
    sets exist to enforce (§V: "To make sure data stored in device buffers is
    not overwritten until kernel executions that operate on the data have
    completed").

    Checks, under *any* legal interleaving (streams advance independently;
    an op may start only when all its ``waits`` have been recorded):

      1. No deadlock: every op's waited-on events are recordable without
         cycles (topological order exists).
      2. Write-after-read safety: an op writing buffer b is ordered (via the
         event/stream happens-before relation) after every earlier op reading
         b, and vice versa (read-after-write).

    Raises ScheduleError on violation.
    """
    ops = sched.ops
    n = len(ops)
    # happens-before edges: stream program order + wait->record edges.
    recorder, preds = dependency_edges(sched)

    # topo order / cycle check (1).
    state = [0] * n  # 0 unvisited, 1 on stack, 2 done
    order: List[int] = []

    def visit(u: int) -> None:
        stack = [(u, iter(preds[u]))]
        state[u] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for v in it:
                if state[v] == 1:
                    raise ScheduleError("event graph has a cycle (deadlock)")
                if state[v] == 0:
                    state[v] = 1
                    stack.append((v, iter(preds[v])))
                    advanced = True
                    break
            if not advanced:
                state[node] = 2
                order.append(node)
                stack.pop()

    for u in range(n):
        if state[u] == 0:
            visit(u)

    # O(n * nstreams) happens-before oracle: per-stream vector clocks
    # computed along the topo order.  clock[i][s] = number of ops on stream s
    # that happen before (or are) op i; since a stream is totally ordered,
    # hb(a, b) <=> clock[b][stream(a)] > pos_in_stream(a).
    nstreams = len(sched.streams)
    pos = [0] * n  # op's position within its own stream
    seen: Dict[int, int] = {}
    for idx, op in enumerate(ops):
        pos[idx] = seen.get(op.stream, 0)
        seen[op.stream] = pos[idx] + 1
    clock = [[0] * nstreams for _ in range(n)]
    for u in order:  # preds appear before u in topo order
        cu = clock[u]
        for p in preds[u]:
            cp = clock[p]
            for s in range(nstreams):
                if cp[s] > cu[s]:
                    cu[s] = cp[s]
        su = ops[u].stream
        if pos[u] + 1 > cu[su]:
            cu[su] = pos[u] + 1

    def hb(a: int, b: int) -> bool:
        return a != b and clock[b][ops[a].stream] > pos[a]

    # Per-buffer reader/writer frontier sweep (2), linear in total buffer
    # accesses: walking a topological linearization, each buffer tracks its
    # last writer and the readers since that write.  A reader must be ordered
    # after the last writer; a writer after the last writer AND every reader
    # since.  Transitivity of hb makes the frontier sufficient: any older
    # accessor is ordered before the frontier op that displaced it.
    last_writer: Dict[Hashable, int] = {}
    readers: Dict[Hashable, List[int]] = {}

    def check(prev: int, cur: int, buf: Hashable) -> None:
        if not hb(prev, cur):
            raise ScheduleError(
                f"unordered conflicting ops on buffer {buf!r}: "
                f"{ops[prev].tag} (issue {prev}) vs {ops[cur].tag} (issue {cur})"
            )

    for u in order:
        op = ops[u]
        for b in op.buffers_read:
            w = last_writer.get(b)
            if w is None:
                # device parity buffers (tuple keys) must be transferred
                # into before anything consumes them; string-keyed carry
                # state is legitimately read before the first write
                # (attention initializes the carry in-handler at step 0)
                if isinstance(b, tuple):
                    raise ScheduleError(
                        f"op {op.tag} reads buffer {b!r} before any "
                        f"transfer wrote it (use-before-transfer)"
                    )
            else:
                check(w, u, b)
            readers.setdefault(b, []).append(u)
        for b in op.buffers_written:
            w = last_writer.get(b)
            if w is not None:
                check(w, u, b)
            for r in readers.get(b, ()):
                if r != u:
                    check(r, u, b)
            last_writer[b] = u
            readers[b] = []
