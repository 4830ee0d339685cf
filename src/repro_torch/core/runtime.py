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

Every GEMM compute op (the ``dgemm`` handler, the in-core path and the
vmem tier) runs that one kernel, so all three sum each output element in
the same order and agree bit for bit.  The ``attn``/``attn_out`` handlers
of out-of-core attention (``core/ooc_attention.py``, registered when
``repro_torch.core`` is imported) run the hand-written flash-decoding
kernel pair (``csrc/flash_attention.cu``).

The factorizations' panel handlers (``panel_chol``, ``panel_trsm``,
``panel_lu``, ``lu_trsm``, ``lu_writeback``) run on the executor's device
through ``torch.linalg``.  ``ScheduleExecutor.run(faults=..., policy=...)``
is the fault-injected path (``repro_torch.fault``): transfer retries with
backoff and block-granular replay of corrupted compute blocks, from
copy-on-write device snapshots.

The hybrid composite (``HYBRID``, ``repro_torch.hybrid.executor``)
registers itself when its module is imported, which
:class:`RuntimeFactory` does on first use.

  * :class:`MeshOocRuntime` — the ``MESH`` tier: a SUMMA ring over the
    ranks of a ``torch.distributed`` device mesh axis, each ring step's
    block product on the same kernel, the next B block's send/receive
    issued before it (NCCL between cards, gloo between CPU ranks).

Every entry point takes ``torch_device`` (default: CUDA).  Without a card
and without ``torch_device="cpu"`` from the caller they raise; on the CPU
they run the same op sequence synchronously with the kernels' plain
versions, which is how the tests hold the port against the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import pipeline as plib
from repro_torch.core.exec_plan import ExecutablePlan, compile_executable
from repro_torch.core.partitioner import GemmPartition
from repro_torch.core.streams import (BlockRef, Device, Op, OpKind, Schedule,
                                      ScheduleError, SliceRef)
from repro_torch.kernels import ops as kops
from repro_torch.obs import get_observability, profiled

def resolve_device(torch_device=None, arg: str = "torch_device"
                   ) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller
    names another.  Raises when CUDA is asked for (explicitly or by
    default) and no card is present — there is no silent CPU fallback;
    the message names the caller's argument ``arg``."""
    dev = torch.device("cuda" if torch_device is None else torch_device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device is available; pass {arg}='cpu' to "
                "run the kernels' plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported torch device {dev}")
    return dev


def tier_bytes(name: str, torch_device=None) -> int:
    """A memory tier's size on the card: ``HBM`` is the device memory
    (``total_memory``), ``MESH`` the same per rank, ``VMEM`` the shared
    memory one block may use (``shared_memory_per_block_optin``, where the
    GEMM kernel's tiles live).  Without a card there is no size to report:
    the caller passes one explicitly."""
    name = name.upper()
    if name not in ("HBM", "MESH", "VMEM"):
        raise ValueError(f"no card size for tier {name!r}")
    dev = resolve_device(torch_device)
    if dev.type != "cuda":
        raise ValueError(
            f"tier {name!r} has no size on {dev}; pass its memory "
            f"explicitly (Device({name!r}, 0, mem_bytes))")
    props = torch.cuda.get_device_properties(dev)
    if name in ("HBM", "MESH"):
        return int(props.total_memory)
    return int(props.shared_memory_per_block_optin)


# the reference's device types with JAX's 64-bit mode off: 64-bit host
# data lands on the device in 32 bits (there is no float64 kernel)
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}
# the operand dtypes kernel 1 takes (all three alike)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a host operand lands on the device in: float64 as float32
    and int64 as int32, as the reference's arrays land with JAX's 64-bit
    mode off; every other dtype as it is."""
    return _CANONICAL.get(dtype, dtype)


def block_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               alpha: float, beta: float,
               out: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """``alpha * a @ b + beta * c`` through the hand-written block GEMM, on
    any numeric operands, as the reference's block GEMM takes them (a
    float32 ``jnp.dot``, scaled and cast to C's dtype).  Operands of one
    kernel dtype go to the kernel as they are; any other mix (integers,
    bool, two float types) is computed in float32 and the result is cast
    to C's dtype.  ``out`` (default: a new tensor) may be ``c``."""
    if a.dtype == b.dtype == c.dtype and a.dtype in _KERNEL_DTYPES:
        return kops.block_matmul(a, b, c, alpha=alpha, beta=beta, out=out,
                                 **kw)
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    res = kops.block_matmul(a.to(**f32), b.to(**f32), c.to(**f32),
                            alpha=alpha, beta=beta, **kw)
    if out is None:
        return res.to(c.dtype)
    return out.copy_(res)


def _is_bf16_array(x) -> bool:
    """An array of ml_dtypes' ``bfloat16`` (which torch cannot read)."""
    return not isinstance(x, torch.Tensor) \
        and str(getattr(x, "dtype", "")) == "bfloat16"


def as_tensor(x) -> torch.Tensor:
    """``torch.as_tensor``, and the same for an ml_dtypes ``bfloat16``
    array (the reference's bf16 host type): it is widened exactly to
    float32 and narrowed to ``torch.bfloat16``, so it is copied, not
    shared."""
    if _is_bf16_array(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
            torch.bfloat16)
    return torch.as_tensor(x)


def host_tensor(x) -> torch.Tensor:
    """A host operand as a CPU tensor, sharing memory with a numpy array
    (so in-place results are visible to the caller's array).  An ml_dtypes
    ``bfloat16`` array is copied instead (see :func:`as_tensor`): an
    in-place result does not reach it."""
    t = as_tensor(x)
    if t.device.type != "cpu":
        raise ValueError(f"host operands must be on the CPU, got {t.device}")
    return t


def zeros_c(entry: str, shape: Tuple[int, int], like: torch.Tensor
            ) -> torch.Tensor:
    """A fresh β = 0 output of ``entry`` (zeros in ``like``'s dtype, on its
    device), made inside the span ``<entry>.zero_c``."""
    with get_observability().span(
            f"{entry}.zero_c",
            copy_bytes=shape[0] * shape[1] * like.element_size()):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _host_output(entry: str, C, shape: Tuple[int, int],
                 like: torch.Tensor) -> torch.Tensor:
    """The host buffer a run of ``entry`` writes: its own zeros when no C
    was given, else a copy of the caller's C (span ``<entry>.clone_c``),
    which the run never writes."""
    if C is None:
        return zeros_c(entry, shape, like)
    C = host_tensor(C)
    with get_observability().span(f"{entry}.clone_c",
                                  copy_bytes=C.numel() * C.element_size()):
        return C.clone()


def _fills(sched: Schedule, name: str) -> bool:
    """Whether ``sched`` makes operand ``name``'s blocks on the device
    (fill ops) instead of copying them from the host."""
    return any(op.kind == OpKind.COMPUTE and isinstance(op.payload, SliceRef)
               and op.payload.operand == name for op in sched.ops)


def device_tensor(x, torch_device: torch.device) -> torch.Tensor:
    """An operand as a contiguous tensor on ``torch_device`` in its
    compute dtype."""
    t = as_tensor(x)
    return t.to(device=torch_device,
                dtype=compute_dtype(t.dtype)).contiguous()


# cudaHostRegisterPortable: page-locked for every CUDA context
_REGISTER_PORTABLE = 1


def _unregister(ptr: int, storage) -> None:
    """``cudaHostUnregister(ptr)``; ``storage`` is held until then so the
    memory cannot be freed while it is registered."""
    err = int(torch.cuda.cudart().cudaHostUnregister(ptr))
    if err != 0:
        raise RuntimeError(f"cudaHostUnregister failed with cudaError {err}")


class PageLock:
    """A CPU tensor's memory page-locked in place (:func:`page_lock`).

    ``release()``, leaving its ``with`` block, or its finaliser (when the
    handle is collected, or at interpreter exit) unregisters the memory,
    once; a second release does nothing.  ``locked`` says whether this
    handle registered the memory (False on a machine with no card, and for
    memory that was page-locked already)."""

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type != "cpu":
            raise ValueError(f"page_lock takes a CPU tensor, got "
                             f"{tensor.device}")
        self._finalizer = None
        storage = tensor.untyped_storage()
        if not torch.cuda.is_available() or storage.nbytes() == 0 \
                or tensor.is_pinned():
            return
        ptr = storage.data_ptr()
        err = int(torch.cuda.cudart().cudaHostRegister(
            ptr, storage.nbytes(), _REGISTER_PORTABLE))
        if err != 0:
            raise RuntimeError(
                f"cudaHostRegister of {storage.nbytes()} bytes failed with "
                f"cudaError {err}")
        self._finalizer = weakref.finalize(self, _unregister, ptr, storage)

    @property
    def locked(self) -> bool:
        return self._finalizer is not None and self._finalizer.alive

    def release(self) -> None:
        if self._finalizer is not None:
            self._finalizer()

    def __enter__(self) -> "PageLock":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def page_lock(tensor: torch.Tensor) -> PageLock:
    """Page-lock ``tensor``'s memory (its whole storage) in place with
    ``cudaHostRegister``, copying nothing: the tensor itself, and every view
    of its storage, then reads ``is_pinned()`` True, so the executor's H2D
    copies read it by DMA with no pinned staging.  Returns the
    :class:`PageLock` whose release unregisters it.  Raises when the
    registration fails; never falls back to a pinned copy, which would
    double the host memory.  On a machine with no card it does nothing."""
    return PageLock(tensor)


def _page_locked(t: torch.Tensor) -> bool:
    """Whether host tensor ``t`` lies in page-locked memory."""
    return t.is_pinned()


class OocRuntime:
    """Pure-virtual base (the paper's ``hclRuntime``)."""

    device: Device
    torch_device: torch.device

    def gemm(self, A, B, C, alpha: float, beta: float,
             part: GemmPartition, **kw):
        raise NotImplementedError

    @classmethod
    def from_device(cls, device: Device, *, mesh=None,
                    **kw) -> "OocRuntime":
        """Factory hook :class:`RuntimeFactory` calls for the registered
        tier (a tier that needs no mesh ignores ``mesh``)."""
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

# Tiers whose runtime lives outside core (imported on first use so core
# stays cycle-free: the hybrid composite pulls in repro_torch.tune, which
# imports repro_torch.core).
_LAZY_RUNTIME_MODULES: Dict[str, str] = {
    "HYBRID": "repro_torch.hybrid.executor"}


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
    # device statuses ``(tag, info)`` that handlers park instead of waiting
    # for the device (a Cholesky's); checked once, after the run
    statuses: List[Tuple[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    # host seconds that handlers report by name (``last_handler_seconds``)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

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


def _fill(dest: torch.Tensor, src: torch.Tensor, ref: SliceRef) -> None:
    """``dest.copy_(src)`` for an H2D slice.  A transposed slice is copied
    in tiles of 64 host rows: torch's one strided copy of a whole
    (rows x panel) host slice into its transpose runs at ~0.2 GB/s on the
    host, the tiles at ~4 GB/s (the SYRK and Cholesky ``Ft`` slices)."""
    if not ref.transpose:
        dest.copy_(src)
        return
    for c in range(0, src.shape[1], 64):
        dest[:, c:c + 64].copy_(src[:, c:c + 64])


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


class _Snapshot:
    """What one parity buffer held at one point of a run: the buffer itself
    while it still holds it, else a device clone."""

    __slots__ = ("key", "clone", "refs")

    def __init__(self, key: Hashable):
        self.key = key
        self.clone: Optional[torch.Tensor] = None
        self.refs = 0


class _ReplayLog:
    """Block-granular replay state of a fault-injected run.

    For each parity key: what it held at its last host-consistent point
    (``clean``: an H2D landing or a slice write-back) and the compute chain
    applied since, each op with what the buffers it read held.  The
    reference's buffers are immutable arrays, so keeping a reference is a
    snapshot; the port's are updated in place, by landings and by the
    compute handlers.  So a snapshot names its buffer until something is
    about to overwrite it (:meth:`before_write`) and only then, if a live
    chain still holds it, is the buffer cloned, on the current stream.  A
    key's chain and its snapshots are released at the key's next
    host-consistent point (:meth:`reset`).  A replay then re-binds exactly
    the inputs the first pass used.
    """

    def __init__(self, bufs: Dict[Hashable, torch.Tensor]):
        self.bufs = bufs
        self.current: Dict[Hashable, _Snapshot] = {}
        self.clean: Dict[Hashable, _Snapshot] = {}
        self.chains: Dict[Hashable, List[Tuple[Op, BlockRef,
                                               Dict[Hashable, _Snapshot]]]] \
            = {}
        self.live_bytes = 0
        self.peak_bytes = 0   # most clone bytes alive at once

    def _hold(self, key: Hashable) -> _Snapshot:
        snap = self.current.get(key)
        if snap is None:
            snap = self.current[key] = _Snapshot(key)
        snap.refs += 1
        return snap

    def _release(self, snap: _Snapshot) -> None:
        snap.refs -= 1
        if snap.refs:
            return
        if snap.clone is not None:
            self.live_bytes -= snap.clone.numel() * snap.clone.element_size()
            snap.clone = None
        elif self.current.get(snap.key) is snap:
            del self.current[snap.key]

    def value(self, snap: _Snapshot) -> torch.Tensor:
        return snap.clone if snap.clone is not None else self.bufs[snap.key]

    def before_write(self, key: Hashable) -> None:
        """``key``'s buffer is about to be overwritten: clone what it holds
        if a live chain holds it."""
        snap = self.current.pop(key, None)
        if snap is not None:
            snap.clone = self.bufs[key].clone()
            self.live_bytes += snap.clone.numel() * snap.clone.element_size()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def reset(self, key: Hashable) -> None:
        """Release ``key``'s chain and clean snapshot (its buffer reaches a
        new host-consistent point; call :meth:`mark_clean` after)."""
        for _, _, reads in self.chains.pop(key, ()):
            for snap in reads.values():
                self._release(snap)
        old = self.clean.pop(key, None)
        if old is not None:
            self._release(old)

    def mark_clean(self, key: Hashable) -> None:
        self.clean[key] = self._hold(key)
        self.chains[key] = []

    def record(self, op: Op, ref: BlockRef) -> None:
        """A successful compute extends the chains of the buffers it wrote,
        holding what the buffers it only read hold now."""
        for k in op.buffers_written:
            chain = self.chains.get(k)
            if chain is not None:
                chain.append((op, ref, {
                    r: self._hold(r) for r in op.buffers_read
                    if r in self.bufs and r not in op.buffers_written}))

    def replay(self, key: Hashable, st: "ExecState", handler_of) -> int:
        """Restore ``key``'s buffer to its clean snapshot and re-run its
        chain, each op on the inputs it first read.  Returns the chain's
        length."""
        self.bufs[key].copy_(self.value(self.clean[key]))
        chain = self.chains[key]
        for op, ref, reads in chain:
            views = {r: self.bufs[r] for r in reads}
            for r, snap in reads.items():
                self.bufs[r] = self.value(snap)
            try:
                handler_of(ref)(st, op, ref)
            finally:
                self.bufs.update(views)
        return len(chain)


def _poison(buf: torch.Tensor) -> None:
    """A corrupted compute result: NaN in a float buffer, 0 in an integer
    one (what the reference's ``jnp.full_like(buf, nan)`` gives)."""
    buf.fill_(float("nan") if buf.is_floating_point() else 0)


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
    previous copy's event has completed.  A slice of an input operand that
    lies in page-locked memory (:func:`page_lock`, decided once per operand
    per run), is contiguous, is not transposed and is already in its compute
    dtype takes the direct path instead: the device copies it by DMA
    straight from the operand, with no staging, fill or wait.  Operands the
    run also writes (``outputs``) always stage, so that no later write-back
    lands under a copy still reading the host.
    A fill op (a COMPUTE op whose payload is a :class:`SliceRef`, ``Z(..)``:
    :attr:`~repro_torch.core.pipeline.StreamedOperand.fill`) sizes and
    binds its block's view as a landing would and zero-fills it on its
    op's stream, reading nothing from the host.
    D2H copies the device block into
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
        stream per schedule stream (``ExecutablePlan.engines``).  The
        engine streams live as long as the executor (the list grows when a
        plan has more engines than earlier ones), so a handler that
        allocates on its op's stream reuses that stream's cached blocks
        from the executor's second run on instead of calling cudaMalloc
        with copies in flight.  Each
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
    ``schedule_stats``), and ``last_direct_h2d_bytes`` those of its H2D
    ops that took the direct path, and ``last_fill_bytes`` those of the
    blocks its fill ops made on the device; ``last_wall_seconds`` brackets
    the run,
    ending when the run's streams have drained (the calling thread's current
    stream and the engine streams, not the whole device: another thread
    may run another executor on the same card).  A run that raises drains
    them too before the error propagates.  On a card,
    ``last_stage_seconds`` is the host time spent filling pinned H2D
    staging from the host operands, and
    ``last_stage_wait_seconds`` the host time spent waiting for a staging
    buffer's previous copy to finish before refilling it.
    ``last_land_seconds`` is the host time spent landing write-backs (the
    wait for each D2H copy's event and the store of its staging into the
    host output).
    ``last_buffer_bytes`` is the size of the run's device parity buffers,
    and ``last_handler_seconds`` the host seconds that handlers reported
    by name in ``state.seconds`` (the LU write-back's row-swap replay).
    Device statuses that handlers park in ``state.statuses`` are checked
    once, after the run (:func:`raise_on_info`).  For the length of a run
    on a card, PyTorch's linalg calls go to cuSOLVER
    (:func:`prefer_cusolver`): the setting is process-wide, so a run
    should not share its process with another thread's linalg calls.
    ``faults=``/``policy=`` arm deterministic fault injection, as in the
    reference: a :class:`~repro_torch.fault.FaultPlan` (or a prepared
    injector, or a ``sched -> plan`` callable; ``policy`` defaults to a
    :class:`~repro_torch.fault.FaultPolicy`) is consulted once per op
    *attempt*, before the op runs.  An injected transfer error on an H2D or
    a slice write-back is retried with the policy's backoff (a failed H2D
    attempt adds its bytes to ``replayed_h2d_bytes``), and so is a
    ``TransferError`` raised while a write-back lands; a corrupted compute
    runs, its output is poisoned, and the written buffer is restored to its
    last host-consistent point and its compute chain re-run
    (block-granular replay, bounded by ``max_retries``); ``device_lost``
    and ``oom`` raise at once for the entry points' degrade ladders.  The
    reference's buffers are immutable, the port's are updated in place,
    so what a replay needs is kept as copy-on-write device clones
    (:class:`_ReplayLog`): ``last_snapshot_bytes`` is the most clone bytes
    alive at once, beyond ``last_buffer_bytes``.  ``last_fault_stats``
    holds the reference's seven counters, published even when the run
    raises; the nominal byte counters still equal ``schedule_stats``.  An
    armed run takes the issue-order loop in either mode.  Only the
    injected taxonomy is recovered: a real CUDA error or out-of-memory
    propagates.  ``faults=None`` costs one branch per op.
    ``record_spans=True`` fills ``last_spans`` with
    ``(tag, stream, start_s, end_s)``: on a card from CUDA events
    around each op's device work (H2D spans exclude the host staging
    copy), on the CPU from the host clock.  When observability is enabled,
    every run publishes its aggregates as ``repro_executor_*`` metrics and
    recorded spans join the active tracer.  While a profiler records, each
    staging fill and each landing is a ``record_function`` range
    (``executor.stage``, ``executor.land``); a run's wall and landing
    seconds join the calling thread's open call record
    (:meth:`~repro_torch.obs.Observability.add_exec_run`).
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
        self.last_direct_h2d_bytes = 0
        self.last_fill_bytes = 0
        self.last_d2h_bytes = 0
        self.last_wall_seconds = 0.0
        self.last_stage_seconds = 0.0
        self.last_stage_wait_seconds = 0.0
        self.last_land_seconds = 0.0
        self.last_buffer_bytes = 0
        self.last_handler_seconds: Dict[str, float] = {}
        # fault-injection accounting of the most recent run (None when it
        # was fault-free): injected / retries / replayed_ops /
        # replayed_h2d_bytes / backoff_seconds / recovered_{retry,replay}
        self.last_fault_stats: Optional[Dict[str, float]] = None
        self.last_snapshot_bytes = 0
        # pinned host staging, (direction, parity key) -> flat tensor
        self._staging: Dict[Tuple[str, Hashable], torch.Tensor] = {}
        # concurrent mode's engine streams on self.torch_device, by engine
        self._engine_streams: List[torch.cuda.Stream] = []

    def _handler(self, ref: BlockRef) -> HandlerFn:
        fn = self.handlers.get(ref.kernel) or _OP_HANDLERS.get(ref.kernel)
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
        """One flat device buffer per parity key that an H2D lands in or a
        fill op makes, sized for the largest block the key ever holds."""
        need: Dict[Hashable, Tuple[int, torch.dtype]] = {}
        for op in sched.ops:
            ref = op.payload
            if op.kind == OpKind.D2H or not isinstance(ref, SliceRef):
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
        tensors (outputs are updated in place; an ml_dtypes ``bfloat16``
        output, which :func:`host_tensor` copies, gets the result copied
        back).  ``faults``/``policy`` arm fault injection (see the class
        docstring)."""
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

        # ---- fault injection state (armed only when a plan is passed) ----
        fi = faults
        fstats: Optional[Dict[str, float]] = None
        log: Optional[_ReplayLog] = None
        if fi is not None:
            from repro_torch.fault.errors import (ComputeFault,
                                                  DeviceLostError, OomError,
                                                  TransferError)
            from repro_torch.fault.plan import REPLAYABLE_KERNELS
            if callable(fi) and not hasattr(fi, "check"):
                fi = fi(sched)            # a sched -> plan factory
            if hasattr(fi, "injector"):   # a FaultPlan: fresh one-shot state
                fi = fi.injector()
            if policy is None:
                from repro_torch.fault.policy import FaultPolicy
                policy = FaultPolicy()
            fstats = {"injected": 0, "retries": 0, "replayed_ops": 0,
                      "replayed_h2d_bytes": 0, "backoff_seconds": 0.0,
                      "recovered_retry": 0, "recovered_replay": 0}
            log = _ReplayLog(st.bufs)

        dev = self.torch_device
        cuda = dev.type == "cuda"
        # an armed plan runs the issue-order loop (one stream), as the
        # reference runs it serially
        concurrent = cuda and self.mode == "concurrent" and fi is None

        self.last_spans = []
        self.last_completion_order = []
        self.last_h2d_bytes = 0
        self.last_direct_h2d_bytes = 0
        self.last_fill_bytes = 0
        self.last_d2h_bytes = 0
        self.last_stage_seconds = 0.0
        self.last_stage_wait_seconds = 0.0
        self.last_land_seconds = 0.0
        self.last_fault_stats = None
        self.last_snapshot_bytes = 0
        obs = get_observability()
        tracer = obs.tracer
        trace = self.record_spans or tracer is not None
        run_offset = tracer.now() if tracer is not None else 0.0
        t_run0 = time.perf_counter()

        flat = self._allocate(sched, st)
        self.last_buffer_bytes = sum(t.numel() * t.element_size()
                                     for t in flat.values())
        # parity key -> (staging view, its copy's event, destination slice)
        pending: Dict[Hashable, Tuple[torch.Tensor, Any, SliceRef]] = {}
        h2d_copied: Dict[Hashable, torch.cuda.Event] = {}
        # input operand -> whether it lies in page-locked memory
        page_locked: Dict[str, bool] = {}

        def locked(name: str) -> bool:
            hit = page_locked.get(name)
            if hit is None:
                hit = page_locked[name] = _page_locked(st.operands[name])
            return hit

        if cuda:
            main = torch.cuda.current_stream(dev)
            if concurrent:
                while len(self._engine_streams) < len(plan.engines):
                    self._engine_streams.append(torch.cuda.Stream(dev))
                engine_streams = self._engine_streams[:len(plan.engines)]
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
            with profiled("executor.land"):
                t0 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                _land(st.outputs[ref.operand], stage, ref)
                self.last_land_seconds += time.perf_counter() - t0
            del pending[key]

        def back_off(attempt: int) -> None:
            fstats["retries"] += 1
            delay = policy.backoff(attempt)
            fstats["backoff_seconds"] += delay
            policy.sleep(delay)

        def flush_retrying(key) -> None:
            # a write-back landing can itself fail transiently; under a
            # policy it gets the same retry treatment as an injected
            # transfer fault (flush keeps the entry in flight until its
            # landing succeeds)
            if fi is None:
                flush(key)
                return
            attempt = 0
            while True:
                try:
                    flush(key)
                except TransferError:
                    attempt += 1
                    if attempt > policy.max_retries:
                        raise
                    back_off(attempt)
                    continue
                if attempt:
                    fstats["recovered_retry"] += 1
                return

        def exec_h2d(op: Op, ref: SliceRef) -> None:
            self.last_h2d_bytes += op.bytes
            key = op.buffers_written[0]
            if key in pending:           # schedule's wC wait point: the
                flush_retrying(key)      # previous occupant lands now
            if ref.operand in st.outputs:  # host coherence on re-read
                src_shape = st.outputs[ref.operand].shape
                for k in [k for k, (_, _, pref) in pending.items()
                          if _spans_overlap(ref, pref, src_shape)]:
                    flush_retrying(k)
            src = _take(st.host(ref.operand), ref)
            if log is not None:          # a fresh load: the old chain goes
                log.reset(key)
                log.before_write(key)
            view = flat[key][:src.numel()].view(src.shape)
            st.bufs[key] = view
            if log is not None:
                log.mark_clean(key)
            direct = (ref.operand not in st.outputs and not ref.transpose
                      and src.is_contiguous() and src.dtype == view.dtype
                      and locked(ref.operand))
            if direct:
                self.last_direct_h2d_bytes += op.bytes
            if not cuda:
                _fill(view, src, ref)
                return
            if direct:
                device_work()
                view.copy_(src, non_blocking=True)
                return
            t0 = time.perf_counter()
            prev = h2d_copied.get(key)
            if prev is not None:          # staging still being read
                prev.synchronize()
            t1 = time.perf_counter()
            stage = self._stage("h2d", key, view)
            with profiled("executor.stage"):
                _fill(stage, src, ref)
            self.last_stage_wait_seconds += t1 - t0
            self.last_stage_seconds += time.perf_counter() - t1
            device_work()
            view.copy_(stage, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            h2d_copied[key] = ev

        def exec_fill(op: Op, ref: SliceRef) -> None:
            # a block made on the device: S(c_ij)'s landing point, buffer
            # and view, but zeros in place of the host's values
            key = op.buffers_written[0]
            if key in pending:           # the previous occupant lands now
                flush_retrying(key)
            if log is not None:
                log.reset(key)
                log.before_write(key)
            like = _take(st.host(ref.operand), ref)
            view = flat[key][:like.numel()].view(like.shape)
            st.bufs[key] = view
            if log is not None:
                log.mark_clean(key)
            self.last_fill_bytes += view.numel() * view.element_size()
            device_work()
            view.zero_()

        def exec_d2h(i: int, op: Op, ref) -> None:
            self.last_d2h_bytes += op.bytes
            if isinstance(ref, BlockRef):  # finalize handler
                for key in list(pending):  # finalizers read/patch host
                    flush_retrying(key)    # state: land in-flight blocks
                device_work()
                handler_for(i, ref)(st, op, ref)
                return
            key = op.buffers_read[0]
            if key in pending:
                flush_retrying(key)
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
            if log is not None:   # write-back: replay restores from here
                log.reset(key)
                log.mark_clean(key)
            if not self.async_writeback:
                flush_retrying(key)

        def exec_compute(i: int, op: Op, ref: BlockRef) -> None:
            if isinstance(ref, SliceRef):
                exec_fill(op, ref)
                return
            if log is not None:
                for k in op.buffers_written:
                    log.before_write(k)
            device_work()
            handler_for(i, ref)(st, op, ref)

        def exec_op(i: int, op: Op) -> None:
            ref = op.payload
            if op.kind == OpKind.H2D:
                exec_h2d(op, ref)
            elif op.kind == OpKind.COMPUTE:
                exec_compute(i, op, ref)
                if log is not None and isinstance(ref, BlockRef):
                    log.record(op, ref)
            else:
                exec_d2h(i, op, ref)

        def run_faulted(i: int, op: Op) -> None:
            ref = op.payload
            attempt = 0              # faulted attempts of this op so far
            while True:
                cls = fi.check(i, op)
                if cls is None:
                    exec_op(i, op)
                    if attempt:
                        fstats["recovered_replay"
                               if op.kind == OpKind.COMPUTE
                               else "recovered_retry"] += 1
                    return
                fstats["injected"] += 1
                obs.instant(f"fault:{cls}", op=i, tag=op.tag,
                            stream=op.stream)
                if cls == "device_lost":
                    raise DeviceLostError(
                        f"injected device_lost at op {i} ({op.tag})")
                if cls == "oom":
                    raise OomError(f"injected oom at op {i} ({op.tag})")
                attempt += 1
                if cls == "h2d_error":
                    if op.kind == OpKind.COMPUTE:
                        raise ValueError(
                            f"fault plan injects h2d_error into compute "
                            f"op {i} ({op.tag})")
                    if attempt > policy.max_retries:
                        raise TransferError(
                            f"op {i} ({op.tag}): transfer failed after "
                            f"{policy.max_retries} retries")
                    if op.kind == OpKind.H2D:
                        # the failed attempt still moved the bytes: extra
                        # traffic is recovery's, nominal counters are not
                        fstats["replayed_h2d_bytes"] += op.bytes
                    back_off(attempt)
                    continue
                # compute_nan: the op runs but its output is corrupt;
                # recover by block-granular replay — restore the written
                # buffer's last host-consistent value and redo the chain
                replayable = (
                    op.kind == OpKind.COMPUTE
                    and len(op.buffers_written) == 1
                    and op.buffers_written[0] in log.clean
                    and getattr(ref, "kernel", None) in REPLAYABLE_KERNELS)
                if op.kind == OpKind.COMPUTE:
                    exec_compute(i, op, ref)
                    for k in op.buffers_written:
                        if k in st.bufs:
                            _poison(st.bufs[k])
                if not replayable or attempt > policy.max_retries:
                    raise ComputeFault(
                        f"op {i} ({op.tag}): compute fault "
                        + ("retries exhausted" if replayable
                           else "not replayable"))
                fstats["replayed_ops"] += log.replay(
                    op.buffers_written[0], st, self._handler) + 1
                # loop: the next attempt re-consults the injector and
                # either faults again (times > 1) or dispatches cleanly

        def drain() -> None:
            # the run's own streams only: another thread's executor (a
            # hybrid member) may be running on the same card
            if concurrent:
                for s in engine_streams:
                    main.wait_stream(s)
            main.synchronize()

        step = exec_op if fi is None else run_faulted
        try:
            with prefer_cusolver(dev):
                for i, op in enumerate(sched.ops):
                    if not cuda:
                        t0 = time.perf_counter() - t_run0
                        step(i, op)
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
                            step(i, op)
                            if trace:
                                t1 = torch.cuda.Event(enable_timing=True)
                                t1.record()
                                marks.append((op, started[0], t1))
                            if concurrent and i in needed:
                                done[i] = torch.cuda.Event()
                                done[i].record()
                    self.last_completion_order.append(i)
            for key in list(pending):
                flush_retrying(key)
        except BaseException:
            if cuda:
                # an aborted run (an injected device_lost or oom, a failed
                # transfer): what it queued finishes before its buffers go
                # back to the allocator and its caller recomputes the work
                drain()
            raise
        finally:
            if fi is not None:
                # publish even when an unrecoverable fault propagates: the
                # caller's degrade handler still needs the record
                self.last_fault_stats = fstats
                self.last_snapshot_bytes = log.peak_bytes
                obs.record_fault_run(sched.meta.get("kernel", "run"), fstats)
        if cuda:
            drain()
            if trace:
                self.last_spans = [
                    (op.tag, op.stream, base.elapsed_time(t0) / 1e3,
                     base.elapsed_time(t1) / 1e3) for op, t0, t1 in marks]
        self.last_wall_seconds = time.perf_counter() - t_run0
        self.last_handler_seconds = dict(st.seconds)
        obs.add_exec_run(self.last_wall_seconds, self.last_land_seconds,
                         self.last_direct_h2d_bytes, self.last_fill_bytes)
        raise_on_info(st.statuses)
        if obs.metrics.enabled:
            obs.record_executor_run(
                sched, self.last_wall_seconds,
                self.last_h2d_bytes, self.last_d2h_bytes,
                spans=self.last_spans if trace else None,
                direct_h2d_bytes=self.last_direct_h2d_bytes,
                fill_bytes=self.last_fill_bytes)
        if tracer is not None and trace and self.last_spans:
            tracer.add_flat_spans(
                self.trace_group
                or f"executor:{sched.meta.get('kernel', 'run')}",
                self.last_spans, offset=run_offset,
                reuse=sched.reuse or None)
        for k, v in outputs.items():
            if _is_bf16_array(v):
                v[...] = st.outputs[k].float().numpy().astype(v.dtype)
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
    block_gemm(st.bufs[op.buffers_read[0]], st.bufs[op.buffers_read[1]], c,
               alpha=float(st.ctx.get("alpha", 1.0)),
               beta=float(st.ctx.get("beta", 0.0)), out=c)


# ---------------------------------------------------------------------------
# Factorization panel ops (the paper's §VII kernels): in-core panel factor /
# solve handlers the factor pipeline interleaves with the streamed dgemm
# trailing update.  Panels are resident parity buffers shaped (m, pw); the
# panel width is recovered from the buffer itself.  Each op runs on the
# buffer's device and enqueues on the current stream (the op's engine
# stream); nothing waits for the device on the host except the
# ``lu_writeback`` finalizer, which must read the panel and its pivots.
# ---------------------------------------------------------------------------
_CUSOLVER_LOCK = threading.Lock()
_cusolver = {"depth": 0, "prev": None}


@contextlib.contextmanager
def prefer_cusolver(dev: torch.device):
    """Within the block, PyTorch's linalg calls on a card go to cuSOLVER
    (``torch.backends.cuda.preferred_linalg_library``, set back on exit).
    Its default sends the LU of a tall panel to MAGMA's hybrid routine,
    which waits for the device on the host and takes ~10x as long at a
    24576 x 2048 panel on an H100 (``chip_smoke.py`` times both);
    cuSOLVER enqueues on the current stream.  :meth:`ScheduleExecutor.run`
    and the factorizations' per-panel loop enter it once.  The setting is
    process-wide: another thread's linalg calls inside the block go to
    cuSOLVER too.  Blocks may nest and overlap across threads (the hybrid
    members' runs): the first to enter sets it, the last to leave sets the
    previous library back."""
    if dev.type != "cuda":
        yield
        return
    with _CUSOLVER_LOCK:
        if _cusolver["depth"] == 0:
            _cusolver["prev"] = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")
        _cusolver["depth"] += 1
    try:
        yield
    finally:
        with _CUSOLVER_LOCK:
            _cusolver["depth"] -= 1
            if _cusolver["depth"] == 0:
                torch.backends.cuda.preferred_linalg_library(
                    _cusolver["prev"])


def chol_panel_solve(pnl: torch.Tensor) -> None:
    """Cholesky panel solve in place: the rows below the panel's ``d x d``
    head become ``rows @ inv(Lkk)^T``.  The solve writes into the rows
    themselves (no result tensor: a contiguous panel is already in the
    solver's transposed layout)."""
    d = pnl.shape[1]
    rows = pnl[d:]
    torch.linalg.solve_triangular(pnl[:d, :d].T, rows, upper=True,
                                  left=False, out=rows)


def getrf_panel(buf: torch.Tensor) -> torch.Tensor:
    """Right-looking LU with partial pivoting on an (m, pw) panel, in place,
    on the panel's device (LAPACK's getrf on the CPU; on a card, PyTorch's
    preferred linalg library's, cuSOLVER's under :func:`prefer_cusolver`).
    The solver factors a column-major copy of the panel (``m x pw``
    elements of device workspace).  Returns LAPACK-style local pivot rows ``piv`` as an int64 tensor
    on that device (column ``j`` swapped panel rows ``j`` and ``piv[j]``);
    L's unit diagonal is implicit, multipliers live below it, U on and
    above.  A zero pivot leaves its column unscaled, as in the reference,
    and is no error."""
    lu, piv, _ = torch.linalg.lu_factor_ex(buf)
    buf.copy_(lu)
    return piv.long() - 1


def lu_row_solve(pnl: torch.Tensor, urow: torch.Tensor) -> None:
    """LU row-panel solve in place: ``urow <- inv(unit-lower Lkk) @ urow``,
    with Lkk the head of the factored panel ``pnl``.  The solve writes into
    ``urow`` itself (contiguous, so no result tensor)."""
    d = pnl.shape[1]
    torch.linalg.solve_triangular(pnl[:d, :d], urow, upper=False, left=True,
                                  unitriangular=True, out=urow)


def _host_pivots(piv) -> np.ndarray:
    return np.asarray(piv.cpu() if isinstance(piv, torch.Tensor) else piv,
                      dtype=np.int64)


def _panel_permutation(piv) -> np.ndarray:
    """The one row order a panel's local pivots amount to: after the swaps
    (in pivot order), panel row ``i`` holds what was row ``p[i]``.  Only
    the rows a swap touched can differ from the identity."""
    piv = _host_pivots(piv)
    p = np.arange(max(len(piv), int(piv.max(initial=-1)) + 1))
    for j, q in enumerate(piv.tolist()):
        p[j], p[q] = p[q], p[j]
    return p


def apply_panel_pivots(A: torch.Tensor, piv, k0: int, k1: int,
                       perm: torch.Tensor,
                       work: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
    """Replay a panel's local pivots on the host matrix columns *outside*
    the panel (left of it: already-written L; right of it: the trailing
    columns), accumulating the global row permutation.  The pivots are
    composed into one permutation (:func:`_panel_permutation`); the rows it
    moves are gathered whole into ``work`` (one contiguous copy a row; a
    flat host tensor reused across panels, since gathering into fresh
    memory takes ~4x as long), their panel columns are put back, and they
    are scattered once.  Returns the work tensor used (a new one when
    ``work`` is None or too small).  A permutation moves values exactly,
    so the result equals the swap-by-swap replay
    (:func:`apply_panel_pivots_plain`, the reference's loop) bit for
    bit."""
    p = _panel_permutation(piv)
    moved = np.flatnonzero(p != np.arange(len(p)))
    if not len(moved):
        return work
    dst = torch.from_numpy(k0 + moved)
    src = torch.from_numpy(k0 + p[moved])
    size = len(moved) * A.shape[1]
    if work is None or work.numel() < size or work.dtype != A.dtype:
        work = torch.empty(size, dtype=A.dtype)
    rows = work[:size].view(len(moved), A.shape[1])
    torch.index_select(A, 0, src, out=rows)
    rows[:, k0:k1] = A[dst, k0:k1]
    A.index_copy_(0, dst, rows)
    perm[dst] = perm[src]
    return work


def apply_panel_pivots_plain(A: torch.Tensor, piv, k0: int, k1: int,
                             perm: torch.Tensor) -> None:
    """The plain version of :func:`apply_panel_pivots`: one swap of two
    host rows per pivot, as the reference replays them."""
    for j, q in enumerate(_host_pivots(piv).tolist()):
        if q != j:
            rows = torch.tensor([k0 + j, k0 + q])
            flip = rows.flip(0)
            A[rows, :k0] = A[flip, :k0]
            A[rows, k1:] = A[flip, k1:]
            perm[rows] = perm[flip]


def raise_on_info(infos: List[Tuple[str, torch.Tensor]]) -> None:
    """Raise for the first failed Cholesky among ``(tag, info)`` pairs
    parked on the device (one copy to the host for all of them)."""
    if not infos:
        return
    codes = torch.stack([info.reshape(()) for _, info in infos]).cpu()
    for (tag, _), code in zip(infos, codes.tolist()):
        if code != 0:
            raise torch.linalg.LinAlgError(
                f"{tag}: the leading minor of order {code} is not positive "
                f"definite (the matrix is not SPD)")


@register_op_handler("panel_chol")
def _panel_chol_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """POTRF: factor the resident panel's diagonal block in-core (the upper
    triangle comes back zeroed).  Its status stays on the device (checking
    it here would wait for the device) and is checked after the run."""
    buf = st.bufs[op.buffers_written[0]]
    d = buf.shape[1]
    L, info = torch.linalg.cholesky_ex(buf[:d, :d])
    buf[:d, :d] = L
    st.statuses.append((op.tag, info))


@register_op_handler("panel_trsm")
def _panel_trsm_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """Cholesky panel solve: sub-diagonal rows <- rows @ inv(Lkk)^T, in the
    resident panel buffer."""
    chol_panel_solve(st.bufs[op.buffers_written[0]])


@register_op_handler("panel_lu")
def _panel_lu_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """GETRF: partial-pivot LU of the resident panel; the local pivot rows
    (on the device) park in scratch for the write-back's row-swap
    replay."""
    st.scratch[("piv", ref.index)] = getrf_panel(
        st.bufs[op.buffers_written[0]])


@register_op_handler("lu_trsm")
def _lu_trsm_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """LU row-panel solve: U[k, k+1:] <- inv(unit-lower Lkk) @ U[k, k+1:],
    with Lkk read from the resident factored panel."""
    pkey, ukey = op.buffers_read
    lu_row_solve(st.bufs[pkey], st.bufs[ukey])


@register_op_handler("lu_writeback")
def _lu_writeback_handler(st: ExecState, op: Op, ref: BlockRef) -> None:
    """LU panel write-back with row-swap replay: land the factored panel and
    apply its pivots to the host columns *outside* the panel (left of it:
    already-written L; right of it: the not-yet-updated trailing columns),
    accumulating the global permutation in scratch.

    It runs when issued, on the host, after the executor has landed every
    pending write-back; its stream has waited for the panel's GETRF.  On a
    card the panel's copy into pinned staging runs while the host replays
    the pivots.  ``st.seconds["row_swap_replay"]`` sums the host time of
    the replays."""
    A = st.outputs["A"]
    n = A.shape[0]
    buf = st.bufs[op.buffers_read[0]]
    pw = buf.shape[1]
    k0 = n - buf.shape[0]
    k1 = k0 + pw
    piv = st.scratch.pop(("piv", ref.index)).cpu()
    perm = st.scratch.setdefault("perm", torch.arange(n))
    done = None
    if buf.device.type == "cuda":
        stage = st.scratch.get("lu_stage")
        if stage is None or stage.numel() < buf.numel():
            stage = torch.empty(buf.numel(), dtype=buf.dtype,
                                pin_memory=True)
            st.scratch["lu_stage"] = stage
        host = stage[:buf.numel()].view(buf.shape)
        host.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        host = buf
    t0 = time.perf_counter()
    st.scratch["lu_rows"] = apply_panel_pivots(A, piv, k0, k1, perm,
                                               st.scratch.get("lu_rows"))
    st.seconds["row_swap_replay"] = st.seconds.get("row_swap_replay", 0.0) \
        + time.perf_counter() - t0
    if done is not None:
        done.synchronize()
    A[k0:, k0:k1] = host


@register_runtime("HBM")
class HostOocRuntime(OocRuntime):
    """Host-driven block streaming: builds (or accepts) a pipeline schedule
    and hands it to the shared :class:`ScheduleExecutor`.

    ``device`` is the hcl tier tuple; by default its memory is the card's
    (``tier_bytes("HBM")``).  ``torch_device`` is the torch device; an
    ``executor`` brings its own.  Host operands stay on the host: numpy
    arrays or CPU tensors in, a CPU tensor out.  ``gemm``/``syrk`` with
    ``C=None`` (β = 0) return an output of their own; a caller's C is
    copied and never written.  A GEMM whose schedule makes C's blocks on
    the device (``fill_c``, what ``gemm`` builds with no C and no faults)
    runs into an uninitialised output that its write-backs cover; any
    other runs into zeros (``<entry>.zero_c``).
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
        sched = schedule or plib.build_gemm_schedule(
            part, nstreams=nstreams, nbuf=nbuf,
            fill_c=C is None and faults is None)
        A, B = host_tensor(A), host_tensor(B)
        shape = (A.shape[0], B.shape[1])
        if not _fills(sched, "C"):
            out = _host_output("gemm", C, shape, A)
        elif C is not None:
            raise ValueError("the schedule makes C's blocks on the device "
                             "(fill_c) and cannot take a caller's C")
        else:
            # write-only: every element lands from the device
            out = torch.empty(shape, dtype=A.dtype)
        with get_observability().span("gemm.execute"):
            self.executor.run(
                sched,
                operands={"A": A, "B": B},
                outputs={"C": out},
                ctx={"alpha": alpha, "beta": beta},
                faults=faults, policy=policy,
            )
        return out

    def syrk(self, P, C, alpha, beta, part: GemmPartition,
             nstreams: int = 2, nbuf: int = 2,
             schedule: Optional[Schedule] = None,
             faults=None, policy=None) -> torch.Tensor:
        """C = alpha * P @ P^T + beta * C via the SYRK pipeline spec."""
        sched = schedule or plib.build_syrk_schedule(
            part, nstreams=nstreams, nbuf=nbuf
        )
        P = host_tensor(P)
        out = _host_output("syrk", C, (P.shape[0], P.shape[0]), P)
        with get_observability().span("syrk.execute"):
            self.executor.run(
                sched,
                operands={"P": P},
                outputs={"C": out},
                ctx={"alpha": alpha, "beta": beta},
                faults=faults, policy=policy,
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
        return block_gemm(
            device_tensor(A, dev), device_tensor(B, dev),
            device_tensor(C, dev), alpha=alpha, beta=beta,
            block=(bm, bn, bk))


def ring_shards(A, B, C, axis_mesh, dev: torch.device):
    """This rank's operands of a SUMMA ring over the 1-D ``axis_mesh``: A's
    and C's row block and B's column block, on ``dev`` (full operands are
    cut, DTensors sharded so already give their shards)."""
    from torch.distributed.tensor import DTensor

    n, me = axis_mesh.size(), axis_mesh.get_local_rank()

    def shard(x, dim):
        if isinstance(x, DTensor):
            return device_tensor(x.to_local(), dev)
        x = as_tensor(x)
        if x.shape[dim] % n:
            raise ValueError(f"SUMMA needs M, N divisible by the mesh axis "
                             f"({n}), got shape {tuple(x.shape)}")
        step = x.shape[dim] // n
        return device_tensor(x.narrow(dim, me * step, step), dev)

    return shard(A, 0), shard(B, 1), shard(C, 0).clone()


def ring_peers(axis_mesh) -> Tuple[int, int]:
    """(send-to, receive-from) global ranks of this rank's ring step: each
    block moves to the previous rank, the reference's ``ppermute`` with
    ``(i, i - 1)``."""
    import torch.distributed as dist

    group, n = axis_mesh.get_group(), axis_mesh.size()
    me = axis_mesh.get_local_rank()
    return (dist.get_global_rank(group, (me - 1) % n),
            dist.get_global_rank(group, (me + 1) % n))


@register_runtime("MESH")
class MeshOocRuntime(OocRuntime):
    """Mesh tier: a SUMMA ring over a ``torch.distributed`` mesh axis.

    The operands are sharded across the 1-D sub-mesh ``mesh[axis]`` (A and
    C by row blocks, B by column blocks); each rank streams the other
    ranks' B blocks through a double buffer while kernel 1 consumes the
    current one: step t issues the next block's send and receive
    (``batch_isend_irecv``) before its product, so the transfer overlaps
    the compute — the paper's two-stream overlap with the link between the
    ranks as the "PCIe link" and the neighbours' memory as the "host
    memory".  ``overlap=False`` keeps the reference's serial order
    (product, then transfer).  The last step sends nothing (no rank reads
    the block it would carry); at one rank the ring is one product and no
    transfer.

    Each product is ``alpha * a @ b + beta * c`` into C's column slice of
    the step (a row-strided view, which kernel 1 takes as it is), so an
    output element is summed in the kernel's one k order and the result
    equals the in-core launch bit for bit.  ``gemm`` returns C as a
    DTensor on ``mesh[axis]`` sharded by rows (``Shard(0)``), as the
    reference returns its sharded array; ``full_tensor()`` gathers it.

    ``device``'s memory defaults to the card's (``tier_bytes("MESH")``,
    per rank); on a CPU mesh the caller passes one.
    """

    def __init__(self, mesh, axis: str = "model",
                 device: Optional[Device] = None):
        names = mesh.mesh_dim_names or ()
        if axis not in names:
            raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
        self.mesh = mesh
        self.axis = axis
        self.axis_mesh = mesh[axis] if mesh.ndim > 1 else mesh
        self.torch_device = resolve_device(mesh.device_type)
        self.device = device or Device(
            "MESH", 0, tier_bytes("MESH", self.torch_device))
        self.last_p2p_bytes = 0

    @classmethod
    def from_device(cls, device: Device, *, mesh=None, torch_device=None,
                    **kw) -> "MeshOocRuntime":
        if mesh is None:
            raise ValueError("MESH runtime needs a torch.distributed "
                             "DeviceMesh (mesh=)")
        rt = cls(mesh, device=device, **kw)
        if torch_device is not None \
                and resolve_device(torch_device) != rt.torch_device:
            raise ValueError(f"torch_device {torch_device} differs from "
                             f"the mesh's {rt.torch_device}")
        return rt

    def gemm(self, A, B, C, alpha, beta, part=None, overlap: bool = True,
             **kw):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Shard

        am, dev = self.axis_mesh, self.torch_device
        n, me = am.size(), am.get_local_rank()
        a, b_cur, acc = ring_shards(A, B, C, am, dev)
        nb = b_cur.shape[1]
        to, frm = ring_peers(am)
        group = am.get_group()
        b_nxt = torch.empty_like(b_cur) if n > 1 else None
        self.last_p2p_bytes = 0

        def exchange():
            ops = [dist.P2POp(dist.isend, b_cur, to, group),
                   dist.P2POp(dist.irecv, b_nxt, frm, group)]
            self.last_p2p_bytes += b_cur.numel() * b_cur.element_size()
            return dist.batch_isend_irecv(ops)

        for t in range(n):
            last = t == n - 1
            reqs = exchange() if overlap and not last else []
            col = ((me + t) % n) * nb
            out = acc[:, col:col + nb]
            block_gemm(a, b_cur, out, alpha=alpha, beta=beta, out=out)
            if not overlap and not last:
                reqs = exchange()
            for r in reqs:
                r.wait()
            if not last:
                b_cur, b_nxt = b_nxt, b_cur
        return DTensor.from_local(acc, am, (Shard(0),), run_check=False)


class RuntimeFactory:
    """``hclRuntimeFactory``: device tuple -> runtime, via the declarative
    registry populated by :func:`register_runtime`.  Extra keyword arguments
    are forwarded to the tier's ``from_device`` hook (``torch_device=``;
    ``mesh=`` for ``MESH``)."""

    @staticmethod
    def create(device: Device, mesh=None, **kw) -> OocRuntime:
        name = device.name.upper()
        cls = _RUNTIME_REGISTRY.get(name)
        if cls is None and name in _LAZY_RUNTIME_MODULES:
            importlib.import_module(_LAZY_RUNTIME_MODULES[name])
            cls = _RUNTIME_REGISTRY.get(name)
        if cls is None:
            raise ValueError(
                f"unknown device type {device.name!r}; registered tiers: "
                f"{RuntimeFactory.registered()}"
            )
        return cls.from_device(device, mesh=mesh, **kw)

    @staticmethod
    def registered() -> List[str]:
        """Tier names ``create`` accepts (registered + lazily importable)."""
        return sorted(set(_RUNTIME_REGISTRY) | set(_LAZY_RUNTIME_MODULES))
