"""OOC runtimes — the ``hclRuntime`` class hierarchy on one CUDA device.

Port of ``src/repro/core/runtime.py``, held against it by
``tests/test_torch_executor.py`` and ``tests/test_torch_oocgemm.py``.

On an H100 the reference's tiers are the paper's own GPU case:

  * :class:`HostOocRuntime` — host RAM -> HBM over PCIe: the
    :class:`ScheduleExecutor` runs a pipeline schedule with pinned staging,
    CUDA streams and CUDA events (the paper's ``hclStream``/``hclEvent``).
  * :class:`VmemOocRuntime` — HBM -> shared memory inside the hand-written
    block GEMM (``csrc/block_matmul.cu``), the analogue of the reference's
    HBM -> VMEM Pallas kernel.

Every compute op of the slice (the ``dgemm`` handler, the in-core path and
the vmem tier) runs that one kernel, so all three sum each output element
in the same order and agree bit for bit.

Not in this slice, and asking for them raises ``NotImplementedError``
naming the ROADMAP module item: ``MeshOocRuntime`` (item 10), the hybrid
composite (item 8), the factorization panel handlers (item 5), the
attention handlers (item 4) and the fault-injected executor path (item 6).

Every entry point takes ``torch_device`` (default: CUDA).  Without a card
and without ``torch_device="cpu"`` from the caller they raise; on the CPU
they run the same op sequence synchronously with the kernels' plain
versions, which is how the tests hold the port against the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, Type

import torch

from repro_torch.core import pipeline as plib
from repro_torch.core.exec_plan import ExecutablePlan, compile_executable
from repro_torch.core.partitioner import GemmPartition
from repro_torch.core.streams import (BlockRef, Device, Op, OpKind, Schedule,
                                      ScheduleError, SliceRef)
from repro_torch.kernels import ops as kops
from repro_torch.obs import get_observability

# what is left out of this slice, by the ROADMAP module item that ports it
NOT_PORTED = {
    "MESH": "the MESH tier (MeshOocRuntime) is ROADMAP module item 10",
    "HYBRID": "the HYBRID composite runtime is ROADMAP module item 8",
    "faults": "fault injection and recovery are ROADMAP module item 6",
    "tune": "tune='auto' (the autotuner) is ROADMAP module item 7",
    "devices": "hybrid co-execution (devices=) is ROADMAP module item 8",
}


# op-handler kernels of the reference that this slice does not have
KERNELS_NOT_PORTED = {
    **dict.fromkeys(("panel_chol", "panel_trsm", "panel_lu", "lu_trsm",
                     "lu_writeback"),
                    "the factorization panel handlers are ROADMAP module "
                    "item 5"),
    **dict.fromkeys(("attn", "attn_out"),
                    "the attention handlers are ROADMAP module item 4"),
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"not ported yet: {NOT_PORTED[what]}")


def resolve_device(torch_device=None) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller
    names another.  Raises when CUDA is asked for (explicitly or by
    default) and no card is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if torch_device is None else torch_device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass torch_device='cpu' to "
                "run the kernels' plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported torch device {dev}")
    return dev


def tier_bytes(name: str, torch_device=None) -> int:
    """A memory tier's size on the card: ``HBM`` is the device memory
    (``total_memory``), ``VMEM`` the shared memory one block may use
    (``shared_memory_per_block_optin``, where the GEMM kernel's tiles
    live).  Without a card there is no size to report: the caller passes
    one explicitly."""
    name = name.upper()
    if name not in ("HBM", "VMEM"):
        raise ValueError(f"no card size for tier {name!r}")
    dev = resolve_device(torch_device)
    if dev.type != "cuda":
        raise ValueError(
            f"tier {name!r} has no size on {dev}; pass its memory "
            f"explicitly (Device({name!r}, 0, mem_bytes))")
    props = torch.cuda.get_device_properties(dev)
    if name == "HBM":
        return int(props.total_memory)
    return int(props.shared_memory_per_block_optin)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype blocks are computed in: float64 host data is computed in
    float32, as the reference does with JAX's 64-bit mode off (there is no
    float64 kernel in this slice)."""
    return torch.float32 if dtype == torch.float64 else dtype


def host_tensor(x) -> torch.Tensor:
    """A host operand as a CPU tensor, sharing memory with a numpy array
    (so in-place results are visible to the caller's array)."""
    t = torch.as_tensor(x)
    if t.device.type != "cpu":
        raise ValueError(f"host operands must be on the CPU, got {t.device}")
    return t


def device_tensor(x, torch_device: torch.device) -> torch.Tensor:
    """An operand as a contiguous tensor on ``torch_device`` in its
    compute dtype."""
    t = torch.as_tensor(x)
    return t.to(device=torch_device,
                dtype=compute_dtype(t.dtype)).contiguous()


class OocRuntime:
    """Pure-virtual base (the paper's ``hclRuntime``)."""

    device: Device
    torch_device: torch.device

    def gemm(self, A, B, C, alpha: float, beta: float,
             part: GemmPartition, **kw):
        raise NotImplementedError

    @classmethod
    def from_device(cls, device: Device, **kw) -> "OocRuntime":
        """Factory hook :class:`RuntimeFactory` calls for the registered
        tier."""
        return cls(device=device, **kw)

    # hcl-style helpers shared by backends ------------------------------------
    def mem_size(self) -> int:  # hclGetMemSize
        return self.device.mem_bytes

    def device_synchronize(self, *tensors) -> None:  # hclDeviceSynchronize
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)


# ===========================================================================
# Runtime registry — tiers self-register instead of being if/elif'd
# ===========================================================================
_RUNTIME_REGISTRY: Dict[str, Type[OocRuntime]] = {}


def register_runtime(name: str) -> Callable[[Type[OocRuntime]],
                                            Type[OocRuntime]]:
    """Class decorator registering an :class:`OocRuntime` under tier
    ``name``; ``RuntimeFactory.create`` dispatches ``Device.name`` through
    this registry via the class's :meth:`OocRuntime.from_device` hook."""

    def deco(cls: Type[OocRuntime]) -> Type[OocRuntime]:
        _RUNTIME_REGISTRY[name.upper()] = cls
        return cls

    return deco


# ===========================================================================
# ScheduleExecutor — the single schedule interpreter for every host path
# ===========================================================================
HandlerFn = Callable[["ExecState", Op, BlockRef], None]
_OP_HANDLERS: Dict[str, HandlerFn] = {}
# bumped on every registration: compiled ExecutablePlans pin the version
# they resolved handlers against, so late registrations invalidate cached
# plans instead of serving stale (or missing) resolutions
_HANDLERS_VERSION = 0


def handlers_version() -> int:
    """Monotonic handler-registry version (plan-cache invalidation key)."""
    return _HANDLERS_VERSION


def register_op_handler(kernel: str) -> Callable[[HandlerFn], HandlerFn]:
    """Register ``fn(state, op, ref)`` for ops whose :class:`BlockRef` payload
    names ``kernel`` — COMPUTE dispatch and "final"-mode D2H finalizers.

    Handlers receive parity buffers positionally via ``op.buffers_read`` /
    ``op.buffers_written`` in the order the :class:`PipelineSpec` declared
    them (``state.bufs[key]`` is a tensor on the executor's device), kernel
    parameters via ``state.ctx``, and may keep carry state in
    ``state.scratch``.  A handler enqueues its device work on the current
    CUDA stream, which the executor sets to the op's engine stream.
    """

    def deco(fn: HandlerFn) -> HandlerFn:
        global _HANDLERS_VERSION
        _OP_HANDLERS[kernel] = fn
        _HANDLERS_VERSION += 1
        return fn

    return deco


@dataclasses.dataclass
class ExecState:
    """Mutable execution state threaded through op handlers."""

    bufs: Dict[Hashable, torch.Tensor]   # device parity buffers (views)
    operands: Dict[str, torch.Tensor]    # host-resident inputs
    outputs: Dict[str, torch.Tensor]     # host results (in-place)
    ctx: Dict[str, Any]                  # kernel parameters
    scratch: Dict[str, Any]              # handler carry state

    def host(self, name: str) -> torch.Tensor:
        """Host array an H2D slices from: inout operands read the live
        output so a kernel can accumulate into what it already wrote."""
        return self.outputs[name] if name in self.outputs \
            else self.operands[name]


def _take(arr, ref: SliceRef):
    if ref.rows is not None:
        arr = arr[ref.rows[0]:ref.rows[0] + ref.rows[1]]
    if ref.cols is not None:
        arr = arr[:, ref.cols[0]:ref.cols[0] + ref.cols[1]]
    return arr.T if ref.transpose else arr


def _spans_overlap(a: SliceRef, b: SliceRef, shape) -> bool:
    def hit(sa, sb, extent):
        lo_a, n_a = sa if sa is not None else (0, extent)
        lo_b, n_b = sb if sb is not None else (0, extent)
        return lo_a < lo_b + n_b and lo_b < lo_a + n_a

    return (a.operand == b.operand
            and hit(a.rows, b.rows, shape[0])
            and hit(a.cols, b.cols, shape[1] if len(shape) > 1 else 1))


def _land(dest: torch.Tensor, arr: torch.Tensor, ref: SliceRef) -> None:
    """Host store of a landed block into its destination slice."""
    if ref.transpose:
        arr = arr.T
    rs, rn = ref.rows if ref.rows is not None else (0, dest.shape[0])
    if dest.dim() > 1:
        cs, cn = ref.cols if ref.cols is not None else (0, dest.shape[1])
        dest[rs:rs + rn, cs:cs + cn].copy_(arr)
    else:
        dest[rs:rs + rn].copy_(arr)


class ScheduleExecutor:
    """Executes a :class:`Schedule` against host arrays on one torch device.

    H2D slices the typed :class:`SliceRef` payload out of the host operand
    into a parity buffer on the device, COMPUTE dispatches the
    :class:`BlockRef` payload through the handler registry, D2H copies a
    parity buffer back into the destination slice (or dispatches a finalize
    handler).  Every run first compiles (or fetches from the per-schedule
    cache) an :class:`~repro_torch.core.exec_plan.ExecutablePlan`.

    Device memory.  One device buffer per parity key is allocated at the
    start of the run, sized for the largest block that key ever holds;
    every landing (ragged edge blocks included) is a contiguous view of it.
    Nothing is allocated per op, so no tensor made on one stream is freed
    while another stream still uses it.  The ``dgemm`` kernel updates its C
    buffer in place (the reference's arrays are immutable, so this is the
    port's one semantic liberty): each element is read once, by the thread
    that writes it, and the schedule's event program orders the buffer's
    next landing after its write-back.

    Transfers on a card.  H2D first makes the (strided or transposed) host
    slice contiguous in a pinned staging buffer, then copies it with
    ``non_blocking=True``; a staging buffer is refilled only after its
    previous copy's event has completed.  D2H copies the device block into
    pinned staging, records an event, and the host stores staging into the
    destination slice only after that event, at the reference's flush
    points: the parity buffer is about to be reused, a finalize handler
    runs, the run ends, or a later H2D re-reads an overlapping region of an
    output operand (the host-coherence rule; with ``beta != 0`` a missed
    flush would read stale C).  ``async_writeback=False`` lands every D2H at
    once instead.  Pinned staging is kept on the executor between runs.

    ``mode``:

      * ``"issue_order"`` (default) — every op is issued from the calling
        thread onto one CUDA stream (the current one), in issue order: the
        differential oracle.
      * ``"concurrent"`` — the same single host thread issues each op onto
        its engine's stream: one H2D stream, one D2H stream and one compute
        stream per schedule stream (``ExecutablePlan.engines``).  Each
        cross-engine edge of ``ExecutablePlan.preds`` becomes a
        ``torch.cuda.Event`` the op's stream waits on — the paper's
        ``hclEvent`` program realised on the device, with no host threads.
        Deadlock-free: every edge points to an op issued earlier, whose
        event is therefore already recorded.

    On the CPU both modes run the ops synchronously in issue order.
    ``last_completion_order`` is the issue order in both modes (the host
    does not observe device completion order).

    ``last_h2d_bytes``/``last_d2h_bytes`` count the bytes of the transfer
    ops performed in the most recent :meth:`run` (they equal
    ``schedule_stats``); ``last_wall_seconds`` brackets the run, ending
    with a device synchronize.  ``record_spans=True`` fills ``last_spans``
    with ``(tag, stream, start_s, end_s)``: on a card from CUDA events
    around each op's device work (H2D spans exclude the host staging
    copy), on the CPU from the host clock.  When observability is enabled,
    every run publishes its aggregates as ``repro_executor_*`` metrics and
    recorded spans join the active tracer.
    """

    MODES = ("issue_order", "concurrent")

    def __init__(self,
                 handlers: Optional[Dict[str, HandlerFn]] = None,
                 async_writeback: bool = True,
                 record_spans: bool = False,
                 trace_group: Optional[str] = None,
                 mode: str = "issue_order",
                 torch_device=None):
        if mode not in self.MODES:
            raise ValueError(
                f"unknown executor mode {mode!r}; expected one of "
                f"{self.MODES}")
        self.torch_device = resolve_device(torch_device)
        self.handlers = dict(handlers) if handlers else {}
        self.async_writeback = async_writeback
        self.record_spans = record_spans
        self.mode = mode
        self.trace_group = trace_group
        self.last_spans: List[Tuple[str, int, float, float]] = []
        self.last_completion_order: List[int] = []
        self.last_h2d_bytes = 0
        self.last_d2h_bytes = 0
        self.last_wall_seconds = 0.0
        # pinned host staging, (direction, parity key) -> flat tensor
        self._staging: Dict[Tuple[str, Hashable], torch.Tensor] = {}

    def _handler(self, ref: BlockRef) -> HandlerFn:
        fn = self.handlers.get(ref.kernel) or _OP_HANDLERS.get(ref.kernel)
        if fn is None and ref.kernel in KERNELS_NOT_PORTED:
            raise NotImplementedError(
                f"not ported yet: {KERNELS_NOT_PORTED[ref.kernel]}")
        if fn is None:
            raise KeyError(
                f"no op handler registered for kernel {ref.kernel!r}; "
                f"known: {sorted(set(_OP_HANDLERS) | set(self.handlers))}"
            )
        return fn

    def _stage(self, direction: str, key: Hashable, like: torch.Tensor
               ) -> torch.Tensor:
        """A contiguous staging view shaped and typed like ``like``: pinned
        on a card, plain host memory on the CPU."""
        n = like.numel()
        buf = self._staging.get((direction, key))
        if buf is None or buf.numel() < n or buf.dtype != like.dtype:
            buf = torch.empty(n, dtype=like.dtype,
                              pin_memory=self.torch_device.type == "cuda")
            self._staging[(direction, key)] = buf
        return buf[:n].view(like.shape)

    def _allocate(self, sched: Schedule, st: ExecState
                  ) -> Dict[Hashable, torch.Tensor]:
        """One flat device buffer per H2D-landed parity key, sized for the
        largest block the key ever holds."""
        need: Dict[Hashable, Tuple[int, torch.dtype]] = {}
        for op in sched.ops:
            ref = op.payload
            if op.kind != OpKind.H2D or not isinstance(ref, SliceRef):
                continue
            src = _take(st.host(ref.operand), ref)
            key = op.buffers_written[0]
            n, _ = need.get(key, (0, None))
            need[key] = (max(n, src.numel()), compute_dtype(src.dtype))
        return {key: torch.empty(n, dtype=dt, device=self.torch_device)
                for key, (n, dt) in need.items()}

    def run(self,
            sched: Schedule,
            operands: Dict[str, Any],
            outputs: Dict[str, Any],
            ctx: Optional[Dict[str, Any]] = None,
            faults=None,
            policy=None) -> ExecState:
        """Run ``sched``; ``operands``/``outputs`` are numpy arrays or CPU
        tensors (outputs are updated in place)."""
        if faults is not None or policy is not None:
            raise not_ported("faults")
        st = ExecState(bufs={},
                       operands={k: host_tensor(v)
                                 for k, v in operands.items()},
                       outputs={k: host_tensor(v)
                                for k, v in outputs.items()},
                       ctx=ctx or {}, scratch={})
        # a hand-built schedule with a broken event graph can still run in
        # issue order (that loop never consults the edges), so compile
        # failures only propagate when the concurrent mode needs the plan
        try:
            plan: Optional[ExecutablePlan] = compile_executable(sched)
        except ScheduleError:
            if self.mode == "concurrent":
                raise
            plan = None
        resolved = plan.resolved if plan is not None else None

        def handler_for(i: int, ref: BlockRef) -> HandlerFn:
            if self.handlers:
                fn = self.handlers.get(ref.kernel)
                if fn is not None:
                    return fn
            if resolved is not None:
                fn = resolved[i]
                if fn is not None:
                    return fn
            return self._handler(ref)

        dev = self.torch_device
        cuda = dev.type == "cuda"
        concurrent = cuda and self.mode == "concurrent"

        self.last_spans = []
        self.last_completion_order = []
        self.last_h2d_bytes = 0
        self.last_d2h_bytes = 0
        obs = get_observability()
        tracer = obs.tracer
        trace = self.record_spans or tracer is not None
        run_offset = tracer.now() if tracer is not None else 0.0
        t_run0 = time.perf_counter()

        flat = self._allocate(sched, st)
        # parity key -> (staging view, its copy's event, destination slice)
        pending: Dict[Hashable, Tuple[torch.Tensor, Any, SliceRef]] = {}
        h2d_copied: Dict[Hashable, torch.cuda.Event] = {}

        if cuda:
            main = torch.cuda.current_stream(dev)
            if concurrent:
                engine_streams = [torch.cuda.Stream(dev)
                                  for _ in plan.engines]
                start = torch.cuda.Event()
                start.record(main)
                for s in engine_streams:
                    s.wait_event(start)
                needed = {p for ps in plan.preds for p in ps}
                done: Dict[int, torch.cuda.Event] = {}
            if trace:
                base = torch.cuda.Event(enable_timing=True)
                base.record(main)
                marks: List[Tuple[Op, Any, Any]] = []
        # timing event of the current op's device work, recorded after its
        # host-side preparation (flushes, staging fill) so a span covers
        # only what the device does
        started: List[Any] = [None]

        def device_work() -> None:
            if cuda and trace:
                started[0] = torch.cuda.Event(enable_timing=True)
                started[0].record()

        def flush(key) -> None:
            stage, ev, ref = pending[key]
            if ev is not None:
                ev.synchronize()
            _land(st.outputs[ref.operand], stage, ref)
            del pending[key]

        def exec_h2d(op: Op, ref: SliceRef) -> None:
            self.last_h2d_bytes += op.bytes
            key = op.buffers_written[0]
            if key in pending:           # schedule's wC wait point: the
                flush(key)               # previous occupant lands now
            if ref.operand in st.outputs:  # host coherence on re-read
                src_shape = st.outputs[ref.operand].shape
                for k in [k for k, (_, _, pref) in pending.items()
                          if _spans_overlap(ref, pref, src_shape)]:
                    flush(k)
            src = _take(st.host(ref.operand), ref)
            view = flat[key][:src.numel()].view(src.shape)
            st.bufs[key] = view
            if not cuda:
                view.copy_(src)
                return
            prev = h2d_copied.get(key)
            if prev is not None:          # staging still being read
                prev.synchronize()
            stage = self._stage("h2d", key, view)
            stage.copy_(src)
            device_work()
            view.copy_(stage, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            h2d_copied[key] = ev

        def exec_d2h(i: int, op: Op, ref) -> None:
            self.last_d2h_bytes += op.bytes
            if isinstance(ref, BlockRef):  # finalize handler
                for key in list(pending):  # finalizers read/patch host
                    flush(key)             # state: land in-flight blocks
                device_work()
                handler_for(i, ref)(st, op, ref)
                return
            key = op.buffers_read[0]
            if key in pending:
                flush(key)
            blk = st.bufs[key]
            stage = self._stage("d2h", key, blk)
            if cuda:
                device_work()
                stage.copy_(blk, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
            else:
                stage.copy_(blk)
                ev = None
            pending[key] = (stage, ev, ref)
            if not self.async_writeback:
                flush(key)

        def exec_op(i: int, op: Op) -> None:
            ref = op.payload
            if op.kind == OpKind.H2D:
                exec_h2d(op, ref)
            elif op.kind == OpKind.COMPUTE:
                device_work()
                handler_for(i, ref)(st, op, ref)
            else:
                exec_d2h(i, op, ref)

        for i, op in enumerate(sched.ops):
            if not cuda:
                t0 = time.perf_counter() - t_run0
                exec_op(i, op)
                if trace:
                    self.last_spans.append(
                        (op.tag, op.stream, t0,
                         time.perf_counter() - t_run0))
            else:
                stream = main
                if concurrent:
                    stream = engine_streams[plan.engine_of[i]]
                    for p in plan.preds[i]:
                        stream.wait_event(done[p])
                with torch.cuda.stream(stream):
                    exec_op(i, op)
                    if trace:
                        t1 = torch.cuda.Event(enable_timing=True)
                        t1.record()
                        marks.append((op, started[0], t1))
                    if concurrent and i in needed:
                        done[i] = torch.cuda.Event()
                        done[i].record()
            self.last_completion_order.append(i)
        for key in list(pending):
            flush(key)
        if cuda:
            if concurrent:
                for s in engine_streams:
                    main.wait_stream(s)
            torch.cuda.synchronize(dev)
            if trace:
                self.last_spans = [
                    (op.tag, op.stream, base.elapsed_time(t0) / 1e3,
                     base.elapsed_time(t1) / 1e3) for op, t0, t1 in marks]
        self.last_wall_seconds = time.perf_counter() - t_run0
        if obs.metrics.enabled:
            obs.record_executor_run(
                sched, self.last_wall_seconds,
                self.last_h2d_bytes, self.last_d2h_bytes,
                spans=self.last_spans if trace else None)
        if tracer is not None and trace and self.last_spans:
            tracer.add_flat_spans(
                self.trace_group
                or f"executor:{sched.meta.get('kernel', 'run')}",
                self.last_spans, offset=run_offset,
                reuse=sched.reuse or None)
        return st


@register_op_handler("noop")
def _noop_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """Buffer-release marker ("keep" write-back mode): nothing to execute."""


@register_op_handler("dgemm")
def _dgemm_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """C_p = alpha * lhs @ rhs + beta * C_p on parity buffers (GEMM + SYRK:
    buffers_read = (lhs, rhs), buffers_written[0] = accumulator), in place
    through the hand-written block GEMM (the reference calls XLA's dot)."""
    c = st.bufs[op.buffers_written[0]]
    kops.block_matmul(st.bufs[op.buffers_read[0]], st.bufs[op.buffers_read[1]],
                      c, alpha=float(st.ctx.get("alpha", 1.0)),
                      beta=float(st.ctx.get("beta", 0.0)), out=c)


@register_runtime("HBM")
class HostOocRuntime(OocRuntime):
    """Host-driven block streaming: builds (or accepts) a pipeline schedule
    and hands it to the shared :class:`ScheduleExecutor`.

    ``device`` is the hcl tier tuple; by default its memory is the card's
    (``tier_bytes("HBM")``).  ``torch_device`` is the torch device; an
    ``executor`` brings its own.  Host operands stay on the host: numpy
    arrays or CPU tensors in, a CPU tensor out.
    """

    def __init__(self, device: Optional[Device] = None,
                 executor: Optional[ScheduleExecutor] = None,
                 torch_device=None):
        if executor is None:
            executor = ScheduleExecutor(torch_device=torch_device)
        elif torch_device is not None \
                and resolve_device(torch_device) != executor.torch_device:
            raise ValueError(
                f"torch_device {torch_device} differs from the executor's "
                f"{executor.torch_device}")
        self.executor = executor
        self.torch_device = executor.torch_device
        self.device = device or Device(
            "HBM", 0, tier_bytes("HBM", self.torch_device))

    def gemm(self, A, B, C, alpha, beta, part: GemmPartition,
             nstreams: int = 2, nbuf: int = 2,
             schedule: Optional[Schedule] = None,
             faults=None, policy=None) -> torch.Tensor:
        if faults is not None or policy is not None:
            raise not_ported("faults")
        sched = schedule or plib.build_gemm_schedule(
            part, nstreams=nstreams, nbuf=nbuf
        )
        out = host_tensor(C).clone()
        self.executor.run(
            sched,
            operands={"A": host_tensor(A), "B": host_tensor(B)},
            outputs={"C": out},
            ctx={"alpha": alpha, "beta": beta},
        )
        return out

    def syrk(self, P, C, alpha, beta, part: GemmPartition,
             nstreams: int = 2, nbuf: int = 2,
             schedule: Optional[Schedule] = None,
             faults=None, policy=None) -> torch.Tensor:
        """C = alpha * P @ P^T + beta * C via the SYRK pipeline spec."""
        if faults is not None or policy is not None:
            raise not_ported("faults")
        sched = schedule or plib.build_syrk_schedule(
            part, nstreams=nstreams, nbuf=nbuf
        )
        out = host_tensor(C).clone()
        self.executor.run(
            sched,
            operands={"P": host_tensor(P)},
            outputs={"C": out},
            ctx={"alpha": alpha, "beta": beta},
        )
        return out


@register_runtime("VMEM")
class VmemOocRuntime(OocRuntime):
    """HBM -> shared-memory tier: one launch of the hand-written block GEMM,
    whose K loop streams (tile x K) panels through shared memory — the
    analogue of the reference's Pallas HBM -> VMEM pipeline.  Operands are
    moved to ``torch_device`` (float64 computed in float32); the result
    stays there."""

    def __init__(self, device: Optional[Device] = None, torch_device=None):
        self.torch_device = resolve_device(torch_device)
        self.device = device or Device(
            "VMEM", 0, tier_bytes("VMEM", self.torch_device))

    def gemm(self, A, B, C, alpha, beta, part: GemmPartition,
             block: Optional[Tuple[int, int, int]] = None, **kw
             ) -> torch.Tensor:
        bm = min(part.bm, 512)
        bn = min(part.bn, 512)
        bk = min(part.K, 512)
        if block is not None:
            bm, bn, bk = block
        dev = self.torch_device
        return kops.block_matmul(
            device_tensor(A, dev), device_tensor(B, dev),
            device_tensor(C, dev), alpha=alpha, beta=beta,
            block=(bm, bn, bk))


class RuntimeFactory:
    """``hclRuntimeFactory``: device tuple -> runtime, via the declarative
    registry populated by :func:`register_runtime`.  Extra keyword arguments
    are forwarded to the tier's ``from_device`` hook (``torch_device=``)."""

    @staticmethod
    def create(device: Device, **kw) -> OocRuntime:
        name = device.name.upper()
        if name in NOT_PORTED:
            raise not_ported(name)
        cls = _RUNTIME_REGISTRY.get(name)
        if cls is None:
            raise ValueError(
                f"unknown device type {device.name!r}; registered tiers: "
                f"{RuntimeFactory.registered()}"
            )
        return cls.from_device(device, **kw)

    @staticmethod
    def registered() -> List[str]:
        """Tier names ``create`` accepts."""
        return sorted(_RUNTIME_REGISTRY)
