"""Port of ``src/repro/core/pipeline.py`` (JAX-free), held against it by
``tests/test_torch_planning.py``; a copy of the reference apart from its
imports.

PipelineSpec DSL — libhclooc's Fig. 2 program, generated from a spec.

The paper hand-writes a ~55-line event/stream program for out-of-core GEMM and
notes (§V) that "this synchronization pattern is common and can be reused for
out-of-core implementations of other data-parallel kernels", proposing a DSL
as future work.  :class:`PipelineSpec` is that DSL: a declarative kernel
description — which operand classes stream through device buffers, which
blocks each pipeline step consumes, what the compute op is and whether it
carries state between steps, and how results are written back — that
:func:`compile_pipeline` turns into an event-correct multi-stream
:class:`~repro_torch.core.streams.Schedule`.

Three kernels ship as specs (DESIGN.md §4):

  * :func:`gemm_pipeline_spec`      — the paper's MMOOC pipeline
    ``S(b_j) S(a_i) S(c_ij) DGEMM R(c_ij)`` with round-robin streams and the
    five event sets (rA, rB, rC, eA, wC).
  * :func:`attention_pipeline_spec` — out-of-core attention over a blocked KV
    cache (beyond paper): same stage graph with an online-softmax carry
    instead of a beta-accumulate and one final write-back.
  * :func:`syrk_pipeline_spec`      — the blocked-Cholesky trailing update
    ``C <- alpha * P @ P^T + beta * C``: the *same* compute handler as GEMM
    with the panel streamed twice (row slices and transposed column slices),
    proving the reuse claim end-to-end.

Schedules are *backend-neutral*: the simulator times them under a hardware
model; :class:`~repro_torch.core.runtime.ScheduleExecutor` runs them with real JAX
ops.  One schedule object drives simulation, host execution, and stats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    Tuple)

from repro_torch.core.partitioner import (AttentionPartition, GemmPartition,
                                    traversal_order)
from repro_torch.core.streams import (
    BlockRef,
    Device,
    Event,
    Op,
    OpKind,
    Schedule,
    SliceRef,
    StreamFactory,
)


# ===========================================================================
# The spec
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class StreamedOperand:
    """One operand class streamed through parity device buffers.

    Attributes:
      name: buffer-class name — keys the device buffers and transfer tags
            (``S(a[..])``); may differ from the host array the slices come
            from (``slice_of``'s ``SliceRef.operand``), e.g. SYRK streams the
            same panel as two operand classes.
      nblocks: distinct blocks of this operand over the whole pipeline.
      block_of: step -> block id this step consumes.  Blocks must be consumed
            in non-decreasing contiguous runs (the paper's column-major order)
            so each block transfers exactly once.
      slice_of: block id -> typed host-slice payload for the H2D op.
      bytes_of: block id -> transfer size (drives the simulator's bandwidth
            model).
      nbuf: device buffers for this class (None = the pipeline's ``nbuf``).
            GEMM's B slice is a 2-deep ping-pong regardless of pipeline depth.
      inout: read-modify-write operand (GEMM's C): its transfer must wait for
            the previous occupant's *write-back*, not just its last read.
      fill: the operand's host values are never read (a beta = 0 C that the
            entry point makes itself): each block starts as zeros made on
            the device by a zero-byte COMPUTE op ``Z(x[..])`` that carries
            the block's :class:`SliceRef` and takes the H2D's place, waits
            and landing event.  Off in every reference-equal schedule.
    """

    name: str
    nblocks: int
    block_of: Callable[[int], int]
    slice_of: Callable[[int], SliceRef]
    bytes_of: Callable[[int], int]
    nbuf: Optional[int] = None
    inout: bool = False
    fill: bool = False


@dataclasses.dataclass(frozen=True)
class ComputeStage:
    """The per-step compute op.

    ``kernel`` keys the executor's handler registry; ``reads`` names the
    operand classes whose parity buffers are passed to the handler *in this
    order* (the positional contract with
    :func:`~repro_torch.core.runtime.register_op_handler` handlers).  ``carry``
    declares a resident accumulator read+written every step, which serializes
    compute across streams (online-softmax state).
    """

    kernel: str
    reads: Tuple[str, ...]
    flops_of: Callable[[int], int]
    carry: bool = False
    tag: Optional[str] = None          # defaults to kernel.upper()
    event: str = "e"                   # compute event name prefix


@dataclasses.dataclass(frozen=True)
class WriteBack:
    """Write-back policy.

    mode:
      * "each"  — D2H the inout ``operand``'s block after every step (MMOOC).
      * "keep"  — no transfer; a zero-flop release op recycles the buffer
                  (SUMMA ``nsteps`` mode: C stays resident).
      * "final" — one D2H at the end dispatching the ``kernel`` finalize
                  handler (attention's normalize-and-emit).
    """

    mode: str
    operand: Optional[str] = None      # inout class ("each"/"keep")
    kernel: Optional[str] = None       # finalize handler key ("final")
    out: Optional[str] = None          # host output name ("final")
    bytes: int = 0                     # final transfer size


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Declarative out-of-core kernel: operands x compute x write-back.

    ``compile_pipeline`` is the only consumer; everything a backend needs at
    execution time rides on the generated ops as typed payloads.
    """

    name: str
    nsteps: int
    operands: Tuple[StreamedOperand, ...]
    compute: ComputeStage
    writeback: WriteBack
    budget: int = 0
    traversal: str = "col"  # step order over the block grid (reporting only)

    def operand(self, name: str) -> StreamedOperand:
        for x in self.operands:
            if x.name == name:
                return x
        raise KeyError(name)


# ===========================================================================
# Spec -> Schedule compiler
# ===========================================================================
EVICT_POLICIES = ("lru", "belady")


class BlockCache:
    """Compile-time model of one operand class's device-resident blocks.

    Generalizes the paper's parity-buffer rule (block ``idx`` lives in buffer
    ``idx % nbuf``, evicting ``idx - nbuf``) to true residency tracking: a
    block stays usable in its slot until capacity forces replacement, so any
    later step that consumes it again skips its H2D entirely — not just the
    immediately following step.

    ``access`` is called once per (step, operand) in schedule order and
    returns hit/miss plus, on an evicting miss, the events proving the
    evicted occupant's last consumer on every stream has finished — the
    residency-aware generalization of ``hclWaitEvent(eA[idx-1])``.

    Policies: "lru" evicts the least-recently-used slot; "belady" evicts the
    slot whose next use lies furthest in the future (MIN).  Schedules are
    static, so the full access sequence — and hence the Belady oracle — is
    known exactly at compile time.
    """

    def __init__(self, name: str, capacity: int, policy: str,
                 accesses: List[Hashable]):
        if policy not in EVICT_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"expected one of {EVICT_POLICIES}")
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.name = name
        self.capacity = capacity
        self.policy = policy
        # next_use[t]: position of the next access to the same block after t
        # (inf if never again) — Belady's oracle, from one backward sweep.
        self.next_use: List[float] = [math.inf] * len(accesses)
        nxt: Dict[Hashable, int] = {}
        for t in range(len(accesses) - 1, -1, -1):
            self.next_use[t] = nxt.get(accesses[t], math.inf)
            nxt[accesses[t]] = t
        self.slots: List[Optional[dict]] = [None] * capacity
        self.where: Dict[Hashable, int] = {}
        self.hits = 0
        self.misses = 0
        self.bytes_moved = 0
        self.bytes_saved = 0

    def access(self, t: int, block: Hashable,
               nbytes: int) -> Tuple[int, bool, Tuple[Event, ...]]:
        """Process the access at sequence position ``t``.

        Returns ``(slot, hit, evict_waits)``; ``evict_waits`` is non-empty
        only when the miss replaces a live occupant.
        """
        if block in self.where:
            slot = self.where[block]
            entry = self.slots[slot]
            entry["last"] = t
            entry["next"] = self.next_use[t]
            self.hits += 1
            self.bytes_saved += nbytes
            return slot, True, ()
        self.misses += 1
        self.bytes_moved += nbytes
        waits: Tuple[Event, ...] = ()
        slot = next((i for i, e in enumerate(self.slots) if e is None), None)
        if slot is None:
            slot = self._victim()
            old = self.slots[slot]
            del self.where[old["block"]]
            waits = tuple(old["released"].values())
        self.slots[slot] = {"block": block, "last": t,
                            "next": self.next_use[t], "released": {},
                            "landing": None}
        self.where[block] = slot
        return slot, False, waits

    def _victim(self) -> int:
        if self.policy == "lru":
            return min(range(self.capacity),
                       key=lambda i: self.slots[i]["last"])
        # belady: furthest next use goes first (never-used-again = inf wins
        # immediately); ties break to the lowest slot for determinism
        return max(range(self.capacity),
                   key=lambda i: (self.slots[i]["next"], -i))

    def set_landing(self, block: Hashable, event: Event) -> None:
        """Remember the H2D completion event of ``block``'s current
        residency; later cache hits wait on it instead of a new transfer."""
        self.slots[self.where[block]]["landing"] = event

    def landing_event(self, block: Hashable) -> Event:
        return self.slots[self.where[block]]["landing"]

    def note_release(self, block: Hashable, stream: int,
                     event: Event) -> None:
        """Record the latest consumer event of ``block`` per stream.  An
        eviction waits on exactly these: earlier consumers on the same
        stream are covered by program order."""
        self.slots[self.where[block]]["released"][stream] = event

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "bytes_moved": self.bytes_moved,
                "bytes_saved": self.bytes_saved}


class BlockPipelineBuilder:
    """Low-level emitter for the paper's round-robin / parity-buffer shape.

    Semantics (faithful to libhclooc §V):
      * ``nbuf`` on-device buffers per streamed operand class; block ``idx``
        occupies parity ``idx % nbuf``.
      * compute for block ``idx`` runs on stream ``idx % nstreams``; the
        prefetch of block ``idx+1`` runs concurrently on stream
        ``(idx+1) % nstreams`` (the paper's ``idx1``/``idx2`` round robin).
      * before a transfer overwrites a parity buffer, it waits on the events
        proving the previous occupant's last consumers finished — the paper's
        ``hclWaitEvent(eA[idx-1])`` / ``eC[idx-1]`` lines.
      * ``nstreams = 1`` degenerates to the fully serial Phi-style pipeline
        (claim C5): program order supplies every dependency.
    """

    def __init__(self, device: Device, nstreams: int, nbuf: int):
        if nbuf < 1 or nstreams < 1:
            raise ValueError("nbuf and nstreams must be >= 1")
        self.nbuf = nbuf
        self.nstreams = nstreams
        self.sched = Schedule(device, StreamFactory.create(device, nstreams))
        self._events: Dict[str, Event] = {}

    def event(self, name: str) -> Event:
        return self._events.setdefault(name, Event(name))

    def compute_stream(self, idx: int) -> int:
        return idx % self.nstreams

    def transfer_stream(self, idx: int) -> int:
        # Transfers overlapping compute of block idx-1 share that block's
        # "other" stream; with one stream everything serializes.
        return idx % self.nstreams

    def issue(self, **kw) -> Op:
        return self.sched.issue(Op(**kw))


def compile_pipeline(
    spec: PipelineSpec,
    nstreams: int = 2,
    nbuf: int = 2,
    device: Optional[Device] = None,
    evict: str = "lru",
) -> Schedule:
    """Compile ``spec`` into an event-correct multi-stream Schedule.

    Event wiring, generalizing the paper's five event sets:

      * each operand class owns a :class:`BlockCache` of its ``nbuf`` device
        buffers.  A step whose block is still resident emits *no* transfer —
        its compute waits on the original landing event; a miss emits an H2D
        recording ``rX[b]`` that waits on the release events of whichever
        block the cache evicts (write-back event for inout operands, last
        per-stream compute events otherwise).
      * compute at step ``s`` waits every operand's landing event (plus the
        previous step's compute event when a carry serializes the stage),
        and records ``e[s]``.
      * write-back per policy: D2H after each step ("each"), a zero-flop
        buffer release ("keep"), or one finalize D2H at the end ("final").

    ``evict`` selects the replacement policy ("lru" or "belady"); the
    per-class hit/miss/bytes counters land on ``Schedule.reuse`` and the
    chosen traversal/policy on ``Schedule.meta``.
    """
    dev = device or Device("HBM", 0, spec.budget)
    b = BlockPipelineBuilder(dev, nstreams, nbuf)
    ev = spec.compute.event
    ctag = spec.compute.tag or spec.compute.kernel.upper()
    wb = spec.writeback

    # one residency cache per operand class, primed with the full (static)
    # access sequence so the Belady oracle is exact
    caches: Dict[str, BlockCache] = {}
    incarnation: Dict[str, Dict[int, int]] = {}
    for x in spec.operands:
        caches[x.name] = BlockCache(
            x.name, x.nbuf or nbuf, evict,
            [x.block_of(s) for s in range(spec.nsteps)])
        incarnation[x.name] = {}

    slot_of: Dict[str, int] = {}
    for s in range(spec.nsteps):
        s_cur = b.compute_stream(s)
        s_xfer = b.transfer_stream(s)

        # -- H2D: bring in each operand block unless it is still resident
        # (a fill operand's block is made on the device instead, moving
        # nothing)
        for x in spec.operands:
            blk = x.block_of(s)
            cache = caches[x.name]
            moved = 0 if x.fill else x.bytes_of(blk)
            slot, hit, evict_waits = cache.access(s, blk, moved)
            slot_of[x.name] = slot
            if hit:
                continue  # resident from an earlier step: no transfer
            # an evicted-then-refetched block needs a fresh event name (and
            # a distinct tag: spans and error messages key on tags)
            inc = incarnation[x.name].get(blk, 0)
            incarnation[x.name][blk] = inc + 1
            suffix = "" if inc == 0 else f"@{inc}"
            landing = b.event(f"r{x.name}[{blk}]{suffix}")
            cache.set_landing(blk, landing)
            head = "Z" if x.fill else "S"
            b.issue(
                kind=OpKind.COMPUTE if x.fill else OpKind.H2D,
                tag=f"{head}({x.name.lower()}[{blk}]){suffix}",
                stream=s_xfer,
                waits=evict_waits,
                records=landing,
                buffers_written=((x.name, slot),),
                bytes=moved,
                payload=x.slice_of(blk),
            )

        # -- COMPUTE: positional buffers per the stage's `reads` contract
        reads = []
        waits = []
        for name in spec.compute.reads:
            x = spec.operand(name)
            reads.append((name, slot_of[name]))
            waits.append(caches[name].landing_event(x.block_of(s)))
        writes = []
        if wb.operand is not None:
            x = spec.operand(wb.operand)
            writes.append((wb.operand, slot_of[wb.operand]))
            waits.append(caches[wb.operand].landing_event(x.block_of(s)))
        if spec.compute.carry:
            reads.append("carry")
            writes.append("carry")
            if s > 0:
                waits.append(b.event(f"{ev}[{s - 1}]"))
        b.issue(
            kind=OpKind.COMPUTE, tag=f"{ctag}[{s}]", stream=s_cur,
            waits=tuple(waits), records=b.event(f"{ev}[{s}]"),
            buffers_read=tuple(reads), buffers_written=tuple(writes),
            flops=spec.compute.flops_of(s),
            payload=BlockRef(kernel=spec.compute.kernel, index=s),
        )

        # -- write-back
        if wb.mode == "each":
            x = spec.operand(wb.operand)
            blk = x.block_of(s)
            b.issue(
                kind=OpKind.D2H, tag=f"R({wb.operand.lower()}[{s}])",
                stream=s_cur,
                waits=(b.event(f"{ev}[{s}]"),),
                records=b.event(f"w{wb.operand}[{s}]"),
                buffers_read=((wb.operand, slot_of[wb.operand]),),
                bytes=x.bytes_of(blk),
                payload=x.slice_of(blk),
            )
        elif wb.mode == "keep":  # resident C (SUMMA mode); buffer recycles
            b.issue(
                kind=OpKind.COMPUTE, tag=f"keep({wb.operand.lower()}[{s}])",
                stream=s_cur,
                waits=(b.event(f"{ev}[{s}]"),),
                records=b.event(f"w{wb.operand}[{s}]"),
                buffers_read=((wb.operand, slot_of[wb.operand]),),
                flops=0,
                payload=BlockRef(kernel="noop", index=s),
            )

        # -- release registration: the events an eviction must wait on
        for x in spec.operands:
            if x.name == wb.operand and wb.mode in ("each", "keep"):
                rel = b.event(f"w{wb.operand}[{s}]")
            else:
                rel = b.event(f"{ev}[{s}]")
            caches[x.name].note_release(x.block_of(s), s_cur, rel)

    if wb.mode == "final":
        b.issue(
            kind=OpKind.D2H, tag=f"R({wb.out})", stream=0,
            waits=(b.event(f"{ev}[{spec.nsteps - 1}]"),),
            records=b.event("done"),
            buffers_read=("carry",),
            bytes=wb.bytes,
            payload=BlockRef(kernel=wb.kernel, index=spec.nsteps - 1),
        )
    b.sched.meta = {"traversal": getattr(spec, "traversal", "col"),
                    "evict": evict, "kernel": spec.name}
    b.sched.reuse = {name: c.stats() for name, c in caches.items()}
    return b.sched


# ===========================================================================
# Kernel specs
# ===========================================================================
def _block_accessors(part: GemmPartition):
    """(rows, cols, flops) accessors over ``part.blocks()`` in issue order —
    the one place that knows the block-tuple layout and the DGEMM flop model
    (multiply-add on the K panel plus the alpha/beta epilogue)."""
    blocks = list(part.blocks())

    def rows(idx):
        return blocks[idx][2], blocks[idx][3]

    def cols(idx):
        return blocks[idx][4], blocks[idx][5]

    def flops(idx):
        rn, cn = rows(idx)[1], cols(idx)[1]
        return 2 * rn * cn * part.K + 3 * rn * cn

    return rows, cols, flops


def _gemm_identity_operands(part: GemmPartition, traversal: str,
                            band: Optional[int],
                            a_name: str, a_slice, a_bytes,
                            b_name: str, b_slice, b_bytes,
                            fill_c: bool = False):
    """Shared GEMM/SYRK operand construction with *identity* block ids.

    The A role is keyed by block row ``i``, the B role by block column ``j``
    and C by the canonical block id ``j*h + i`` — so a step revisiting a row
    or column presents the *same* block id to the compiler's residency cache
    and its H2D is skipped whenever the block is still resident.  ``order``
    is the (i, j) step sequence produced by
    :func:`~repro_torch.core.partitioner.traversal_order`.
    """
    bpe = part.bytes_per_el
    order = traversal_order(part.h, part.w, traversal, band=band)
    i_of = [ij[0] for ij in order]
    j_of = [ij[1] for ij in order]
    cid_of = [j * part.h + i for i, j in order]

    a = StreamedOperand(
        name=a_name, nblocks=part.h, block_of=lambda s: i_of[s],
        slice_of=a_slice, bytes_of=a_bytes,
    )
    bb = StreamedOperand(
        name=b_name, nblocks=part.w, block_of=lambda s: j_of[s],
        slice_of=b_slice, bytes_of=b_bytes,
        nbuf=2,  # ping-pong regardless of pipeline depth (paper Fig. 2)
    )
    c = StreamedOperand(
        name="C", nblocks=part.nblocks, block_of=lambda s: cid_of[s],
        slice_of=lambda cid: SliceRef(
            "C", cid, rows=part.block_rows(cid % part.h),
            cols=part.block_cols(cid // part.h)),
        bytes_of=lambda cid: part.block_rows(cid % part.h)[1]
        * part.block_cols(cid // part.h)[1] * bpe,
        inout=True, fill=fill_c,
    )

    def flops(s):
        rn = part.block_rows(i_of[s])[1]
        cn = part.block_cols(j_of[s])[1]
        return 2 * rn * cn * part.K + 3 * rn * cn

    return a, bb, c, flops


def gemm_pipeline_spec(part: GemmPartition,
                       write_back: bool = True,
                       traversal: str = "col",
                       band: Optional[int] = None,
                       reuse: bool = True,
                       fill_c: bool = False) -> PipelineSpec:
    """The paper's MMOOC pipeline as a spec.

    Stage set per C block (i, j), idx = j*h + i (column-major so each B slice
    transfers once per column):

      S(b_j)   H2D   once per column j           -> records rB[j]
      S(a_i)   H2D   once per block              -> records rA[idx]
      S(c_ij)  H2D   once per block              -> records rC[idx]
      DGEMM    COMP  waits rA,rB,rC              -> records eA[idx]
      R(c_ij)  D2H   same stream as DGEMM        -> records wC[idx]

    With ``reuse=True`` (the default) the A/B/C operands carry *identity*
    block ids (row, column, canonical C id) so the compiler's residency
    cache can skip re-transfers across non-adjacent steps, and ``traversal``
    reorders the step sequence to shrink reuse distance (``band`` sizes the
    "blocked" traversal's row bands).  ``reuse=False`` reproduces the seed
    compiler's per-step ids — every A/C recurrence re-transfers — and is the
    naive baseline ``benchmarks/bench_reuse.py`` measures against.

    ``fill_c=True`` makes C write-only (a beta = 0 output that the caller
    never sees before the run): each S(c_ij) becomes Z(c_ij), a zero-fill
    of the block's buffer on the device with S(c_ij)'s stream, waits and
    landing event, and no transfer (:attr:`StreamedOperand.fill`).
    """
    bpe = part.bytes_per_el

    if reuse:
        a, bb, c, flops = _gemm_identity_operands(
            part, traversal, band,
            "A",
            lambda i: SliceRef("A", i, rows=part.block_rows(i)),
            lambda i: part.block_rows(i)[1] * part.K * bpe,
            "B",
            lambda j: SliceRef("B", j, cols=part.block_cols(j)),
            lambda j: part.K * part.block_cols(j)[1] * bpe,
            fill_c=fill_c,
        )
    else:
        if traversal != "col":
            raise ValueError(
                "reuse=False fixes the paper's column-major order "
                "(the naive baseline)")
        rows, cols, flops = _block_accessors(part)
        a = StreamedOperand(
            name="A", nblocks=part.nblocks, block_of=lambda s: s,
            slice_of=lambda blk: SliceRef("A", blk, rows=rows(blk)),
            bytes_of=lambda blk: rows(blk)[1] * part.K * bpe,
        )
        bb = StreamedOperand(
            name="B", nblocks=part.w, block_of=lambda s: s // part.h,
            slice_of=lambda j: SliceRef("B", j, cols=part.block_cols(j)),
            bytes_of=lambda j: part.K * part.block_cols(j)[1] * bpe,
            nbuf=2,
        )
        c = StreamedOperand(
            name="C", nblocks=part.nblocks, block_of=lambda s: s,
            slice_of=lambda blk: SliceRef("C", blk, rows=rows(blk),
                                          cols=cols(blk)),
            bytes_of=lambda blk: rows(blk)[1] * cols(blk)[1] * bpe,
            inout=True, fill=fill_c,
        )
    return PipelineSpec(
        name="gemm",
        nsteps=part.nblocks,
        operands=(bb, a, c),  # issue order: S(b) S(a) S(c), as in Fig. 2
        compute=ComputeStage(
            kernel="dgemm", reads=("A", "B"), tag="DGEMM", event="eA",
            flops_of=flops,
        ),
        writeback=WriteBack(mode="each" if write_back else "keep",
                            operand="C"),
        budget=part.budget,
        traversal=traversal,
    )


def attention_pipeline_spec(
    part: AttentionPartition,
    kv_heads: int,
    head_dim: int,
    q_heads: int,
) -> PipelineSpec:
    """OOC attention: stream KV blocks, accumulate online-softmax partials.

    Demonstrates the paper's claim that the MMOOC synchronization pattern is
    reusable for other data-parallel kernels: the stage graph is identical —
    only the compute op (ATTN with (m, l, acc) carry) and the absence of a
    per-block write-back (one final merge instead) differ.
    """
    bpe = part.bytes_per_el
    blk_bytes = part.bs * kv_heads * head_dim * bpe

    def kv_rows(blk):
        lo = blk * part.bs
        return lo, min(part.S, (blk + 1) * part.bs) - lo

    def operand(name):
        return StreamedOperand(
            name=name, nblocks=part.nblocks, block_of=lambda s: s,
            slice_of=lambda blk: SliceRef(name, blk, rows=kv_rows(blk)),
            bytes_of=lambda blk: blk_bytes,
        )

    return PipelineSpec(
        name="attention",
        nsteps=part.nblocks,
        operands=(operand("K"), operand("V")),
        compute=ComputeStage(
            kernel="attn", reads=("K", "V"), tag="ATTN", event="eKV",
            carry=True,
            flops_of=lambda s: 2 * q_heads * part.bs * head_dim * 2,
        ),
        writeback=WriteBack(mode="final", kernel="attn_out", out="out",
                            bytes=q_heads * head_dim * bpe),
        budget=part.budget,
    )


def syrk_pipeline_spec(part: GemmPartition,
                       alpha_tag: str = "P",
                       pt_source: Optional[str] = None,
                       traversal: str = "col",
                       band: Optional[int] = None,
                       reuse: bool = True) -> PipelineSpec:
    """Blocked SYRK ``C <- alpha * P @ P^T + beta * C`` as a spec.

    The Cholesky trailing update, first-class: the same ``dgemm`` handler as
    MMOOC consumes the panel twice — row slices (``Pr``, the A role) and
    transposed row slices (``Pt``, the B role) — with no host-side ``P.T``
    materialization.  ``part`` partitions the symmetric C (M = N = trailing
    dim, K = panel width).

    ``pt_source`` names a *separate* host operand the transposed slices
    stream from (default: the same ``alpha_tag`` array).  The hybrid
    co-scheduler uses this for row-band SYRK: each device's ``Pr`` reads its
    band of the panel while ``Pt`` still spans every row of the full panel,
    so the band operand and the full panel must be distinct host arrays.
    """
    bpe = part.bytes_per_el
    pt_src = pt_source or alpha_tag

    if reuse:
        pr, pt, c, flops = _gemm_identity_operands(
            part, traversal, band,
            "Pr",
            lambda i: SliceRef(alpha_tag, i, rows=part.block_rows(i)),
            lambda i: part.block_rows(i)[1] * part.K * bpe,
            "Pt",
            lambda j: SliceRef(pt_src, j, rows=part.block_cols(j),
                               transpose=True),
            lambda j: part.block_cols(j)[1] * part.K * bpe,
        )
    else:
        if traversal != "col":
            raise ValueError(
                "reuse=False fixes the paper's column-major order "
                "(the naive baseline)")
        rows, cols, flops = _block_accessors(part)
        pr = StreamedOperand(
            name="Pr", nblocks=part.nblocks, block_of=lambda s: s,
            slice_of=lambda blk: SliceRef(alpha_tag, blk, rows=rows(blk)),
            bytes_of=lambda blk: rows(blk)[1] * part.K * bpe,
        )
        pt = StreamedOperand(
            name="Pt", nblocks=part.w, block_of=lambda s: s // part.h,
            slice_of=lambda j: SliceRef(pt_src, j, rows=part.block_cols(j),
                                        transpose=True),
            bytes_of=lambda j: part.block_cols(j)[1] * part.K * bpe,
            nbuf=2,
        )
        c = StreamedOperand(
            name="C", nblocks=part.nblocks, block_of=lambda s: s,
            slice_of=lambda blk: SliceRef("C", blk, rows=rows(blk),
                                          cols=cols(blk)),
            bytes_of=lambda blk: rows(blk)[1] * cols(blk)[1] * bpe,
            inout=True,
        )
    return PipelineSpec(
        name="syrk",
        nsteps=part.nblocks,
        operands=(pt, pr, c),
        compute=ComputeStage(
            kernel="dgemm", reads=("Pr", "Pt"), tag="SYRK", event="eP",
            flops_of=flops,
        ),
        writeback=WriteBack(mode="each", operand="C"),
        budget=part.budget,
        traversal=traversal,
    )


def vendor_pipeline_spec(part: GemmPartition, tile: int = 512) -> PipelineSpec:
    """CUBLAS-XT-style baseline spec (the paper's C3 comparison point).

    CUBLAS-XT tiles C into fixed square blocks (default ~4k) and, per tile,
    synchronously streams the corresponding A-row and B-column *panels* —
    i.e. B panels are re-sent for every row of tiles (no column reuse) and
    nothing overlaps.  The spec models exactly that: per-step B blocks (every
    step re-transfers its panel), single buffers, compiled with one stream.
    """
    bpe = part.bytes_per_el
    vpart = GemmPartition(
        part.M, part.N, part.K,
        (part.M + tile - 1) // tile, (part.N + tile - 1) // tile,
        min(tile, part.M), min(tile, part.N), bpe, part.budget)
    rows, cols, flops = _block_accessors(vpart)

    a = StreamedOperand(
        name="A", nblocks=vpart.nblocks, block_of=lambda s: s,
        slice_of=lambda blk: SliceRef("A", blk, rows=rows(blk)),
        bytes_of=lambda blk: rows(blk)[1] * part.K * bpe,
        nbuf=1,
    )
    bb = StreamedOperand(  # re-sent per C tile: block id == step (no reuse)
        name="B", nblocks=vpart.nblocks, block_of=lambda s: s,
        slice_of=lambda blk: SliceRef("B", blk, cols=cols(blk)),
        bytes_of=lambda blk: part.K * cols(blk)[1] * bpe,
        nbuf=1,
    )
    c = StreamedOperand(
        name="C", nblocks=vpart.nblocks, block_of=lambda s: s,
        slice_of=lambda blk: SliceRef("C", blk, rows=rows(blk),
                                      cols=cols(blk)),
        bytes_of=lambda blk: rows(blk)[1] * cols(blk)[1] * bpe,
        nbuf=1, inout=True,
    )
    return PipelineSpec(
        name="vendor",
        nsteps=vpart.nblocks,
        operands=(bb, a, c),
        compute=ComputeStage(
            kernel="dgemm", reads=("A", "B"), tag="DGEMM", event="eA",
            flops_of=flops,
        ),
        writeback=WriteBack(mode="each", operand="C"),
        budget=part.budget,
    )


# ===========================================================================
# Factorization pipeline — the paper's §VII future work as one multi-kernel
# lookahead program (DESIGN.md §8)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class FactorPipelineSpec:
    """Blocked right-looking factorization (Cholesky or partial-pivot LU) as
    ONE multi-kernel pipeline.

    Unlike :class:`PipelineSpec` (a single homogeneous compute stage), a
    factorization interleaves *panel* ops — in-core POTRF/GETRF on a resident
    panel column, TRSM panel solves — with the streamed SYRK/GEMM trailing
    update of the shrinking sub-matrix.  ``compile_factor_pipeline`` turns
    this spec into one event-correct :class:`~repro_torch.core.streams.Schedule`
    that the ordinary executor/simulator machinery consumes, so the whole
    factorization simulates, traces and executes like any other kernel.

    Attributes:
      kind: "cholesky" or "lu".
      n: matrix order (square, host-resident).
      panel: panel width (last panel may be narrower).
      bm, bn: trailing-update C block dims (shared across panels; per-panel
        grids are ``ceil(m_k/bm) x ceil(m_k/bn)`` over the shrinking
        trailing dim ``m_k``).
      lookahead: 0 factors panel ``k+1`` only after trailing update ``k``
        fully drained (the sequential per-panel loop); >= 1 issues panel
        ``k+1``'s transfer+factor as soon as the trailing blocks covering
        its columns are written back, overlapping the panel critical path
        with the remaining trailing stream.  Depths beyond 1 only add panel
        parity buffers (the data dependencies serialize deeper lookahead).
    """

    kind: str
    n: int
    panel: int
    bm: int
    bn: int
    bytes_per_el: int
    budget: int
    lookahead: int = 1

    @property
    def npanels(self) -> int:
        return max(1, math.ceil(self.n / self.panel))

    @property
    def npbuf(self) -> int:
        """Panel parity buffers: lookahead panels in flight plus the one
        being consumed."""
        return min(max(self.lookahead, 0), self.npanels - 1) + 1

    def panel_range(self, k: int) -> Tuple[int, int]:
        """(k0, k1) column/row extent of panel ``k``."""
        k0 = k * self.panel
        return k0, min(self.n, k0 + self.panel)

    def panel_bytes(self) -> int:
        """Resident bytes of the ``npbuf`` largest panel columns (plus, for
        LU, their U row panels) — the reserve charged against the budget
        before the trailing blocks are planned."""
        pw = min(self.panel, self.n)
        pnl = sum((self.n - i * pw) * pw
                  for i in range(self.npbuf) if i * pw < self.n)
        if self.kind == "lu":
            pnl += sum(pw * max(self.n - (i + 1) * pw, 0)
                       for i in range(self.npbuf))
        return pnl * self.bytes_per_el

    def working_set_bytes(self, nbuf: int = 2) -> int:
        """Worst-case resident bytes: :meth:`panel_bytes` plus the stage-0
        trailing SYRK/GEMM working set under the generalized ``nbuf``-aware
        model."""
        pw = min(self.panel, self.n)
        m0 = self.n - pw
        trail = 0
        if m0 > 0:
            part = GemmPartition(m0, m0, pw,
                                 math.ceil(m0 / self.bm),
                                 math.ceil(m0 / self.bn),
                                 self.bm, self.bn, self.bytes_per_el,
                                 self.budget)
            trail = part.working_set_bytes(nbuf, None)
        return self.panel_bytes() + trail


def factor_pipeline_spec(
    n: int,
    panel: int,
    budget_bytes: int,
    bytes_per_el: int = 4,
    *,
    kind: str = "cholesky",
    lookahead: int = 1,
    nbuf: int = 2,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
) -> FactorPipelineSpec:
    """Plan a factorization pipeline that fits ``budget_bytes``.

    The panel buffers (and LU's U-row buffers) are charged against the
    budget first; the remainder sizes the trailing-update blocks through the
    ordinary partition planner on the *largest* trailing shape
    ``(n-panel) x (n-panel) x panel`` — later panels reuse the same block
    dims over shrinking grids.  Raises ValueError when even the minimum
    aligned configuration cannot fit (callers may degrade ``lookahead`` or
    ``panel`` and retry — :func:`repro_torch.core.ooc_factor.ooc_cholesky` does).
    """
    if kind not in ("cholesky", "lu"):
        raise ValueError(f"unknown factor kind {kind!r}")
    if n <= 0 or panel <= 0:
        raise ValueError(f"bad factor shape n={n}, panel={panel}")
    pw = min(panel, n)
    probe = FactorPipelineSpec(kind, n, pw, bm or 1, bn or 1,
                               bytes_per_el, budget_bytes, lookahead)
    pnl_bytes = probe.working_set_bytes(nbuf) if n <= pw else None
    if n <= pw:  # single panel: no trailing update to plan
        if pnl_bytes > budget_bytes:
            raise ValueError(
                f"{kind} panel {n}x{pw} needs {pnl_bytes}B resident, "
                f"budget is {budget_bytes}B")
        return dataclasses.replace(probe, bm=pw, bn=pw)
    if bm is None or bn is None:
        reserve = probe.panel_bytes()
        remaining = budget_bytes - reserve
        if remaining <= 0:
            raise ValueError(
                f"{kind} lookahead={lookahead} panel buffers alone need "
                f"{reserve}B, budget is {budget_bytes}B")
        from repro_torch.core.partitioner import plan_gemm_partition
        part = plan_gemm_partition(n - pw, n - pw, pw, remaining,
                                   bytes_per_el, nbuf=nbuf)
        bm, bn = part.bm, part.bn
    spec = FactorPipelineSpec(kind, n, pw, bm, bn, bytes_per_el,
                              budget_bytes, lookahead)
    need = spec.working_set_bytes(nbuf)
    if need > budget_bytes:
        raise ValueError(
            f"{kind} pipeline (panel={pw}, lookahead={lookahead}, "
            f"bm={bm}, bn={bn}) needs {need}B resident, budget is "
            f"{budget_bytes}B")
    return spec


def _stage_grid(o: int, m: int, bm: int, bn: int):
    """Trailing-stage block descriptors: (i, j, rows, cols) in global
    coordinates over the ``m x m`` trailing square at origin ``o``, in the
    paper's column-major order."""
    h = math.ceil(m / bm)
    w = math.ceil(m / bn)
    out = []
    for j in range(w):
        cs = o + j * bn
        cn = min(bn, o + m - cs)
        for i in range(h):
            rs = o + i * bm
            rn = min(bm, o + m - rs)
            out.append((i, j, (rs, rn), (cs, cn)))
    return out


def _hits(span: Tuple[int, int], lo: int, hi: int) -> bool:
    return span[0] < hi and lo < span[0] + span[1]


def _stage_split(spec: FactorPipelineSpec, k: int):
    """(prio, rest) trailing blocks of stage ``k`` under the lookahead
    policy — the single source of truth for trailing emission order, shared
    by the compiler's main loop and the residency pre-pass."""
    k0, k1 = spec.panel_range(k)
    if k1 >= spec.n:
        return [], []
    blocks = _stage_grid(k1, spec.n - k1, spec.bm, spec.bn)
    if spec.kind != "lu":
        # Cholesky is symmetric: nothing ever reads the strict upper
        # triangle (panels and multiplier slices are at-or-below the
        # diagonal, np.linalg.cholesky reads only the lower half, and
        # ooc_cholesky tril's the result), so blocks entirely above it are
        # dead work — skipping them halves the trailing flops and traffic.
        # Diagonal-crossing blocks stay whole.
        blocks = [blk for blk in blocks if blk[2][0] + blk[2][1] > blk[3][0]]
    if max(0, spec.lookahead) == 0 or k == spec.npanels - 1:
        return blocks, []
    nk0, nk1 = spec.panel_range(k + 1)
    # prio: the leading block column(s) — what the next panel factor reads.
    # Whole columns only, so each column's once-per-column Ft transfer stays
    # adjacent to all its consumers.  (LU's U row panel additionally needs
    # the first block *row*, but its chain is fenced behind the swap replay
    # — which waits on the whole stage — so prioritizing it buys nothing.)
    prio = [blk for blk in blocks if _hits(blk[3], nk0, nk1)]
    rest = [blk for blk in blocks if not _hits(blk[3], nk0, nk1)]
    return prio, rest


def _trailing_emission_order(spec: FactorPipelineSpec):
    """(stage, block) pairs in the exact order the compiler emits trailing
    blocks: each iteration drains the previous stage's deferred ``rest``
    before issuing stage ``k``'s ``prio``.  Feeds the Fr residency cache its
    full access sequence so the Belady oracle sees the true future."""
    out, rest, rest_stage = [], [], -1
    for k in range(spec.npanels):
        out.extend((rest_stage, blk) for blk in rest)
        prio, rest = _stage_split(spec, k)
        rest_stage = k
        out.extend((k, blk) for blk in prio)
    assert not rest, "internal: trailing blocks left unemitted"
    return out


def compile_factor_pipeline(
    spec: FactorPipelineSpec,
    nstreams: int = 2,
    nbuf: int = 2,
    device: Optional[Device] = None,
    evict: str = "lru",
) -> Schedule:
    """Compile a factorization spec into one event-correct Schedule.

    Program shape per panel ``k`` (all operands slice the single host
    matrix ``A``; trailing updates run the ordinary ``dgemm`` handler with
    ``ctx = {alpha: -1, beta: 1}``):

      Cholesky: ``S(pnl) POTRF TRSM R(pnl)`` then stream the SYRK trailing
      blocks; LU: ``S(pnl) GETRF`` then a ``lu_writeback`` finalize D2H that
      replays the panel's row swaps on the host columns outside the panel,
      then ``S(ur) TRSM R(ur)`` for the U row panel, then the GEMM trailing
      blocks.

    Lookahead wiring: the trailing blocks covering the *next* panel (its
    columns, plus its U row for LU) are emitted and event-ordered first;
    panel ``k+1``'s transfer+factor waits only on those, so it overlaps the
    rest of trailing update ``k`` — in the simulator via the event graph and
    in the executor via issue order (panel front issued before the rest).
    LU's swap replay additionally waits on every stage-``k`` write-back (the
    replay touches the whole trailing region), so its lookahead overlap is
    the panel transfer + GETRF only; Cholesky's whole panel chain overlaps.
    With ``lookahead=0`` the next panel instead waits on every trailing
    write-back: the sequential per-panel loop, as one schedule.

    The left-multiplier slices (``Fr``) live in a :class:`BlockCache` keyed
    by (stage, block row): every block in block row ``i`` of stage ``k``
    reads the *same* panel-row slice, so only the first emitted block of a
    resident row pays its H2D — the rest hit.  ``evict`` selects the cache's
    replacement policy; the pre-computed trailing emission order feeds the
    Belady oracle.
    """
    n, bpe, lu = spec.n, spec.bytes_per_el, spec.kind == "lu"
    npanels, npbuf = spec.npanels, spec.npbuf
    lookahead = max(0, spec.lookahead)
    dev = device or Device("HBM", 0, spec.budget)
    # trailing blocks round-robin the first `nstreams` streams; the panel
    # chain gets a dedicated stream so a factored-early panel never blocks
    # trailing transfers queued behind it in stream order (the classic
    # lookahead layout: panel stream + update streams)
    b = BlockPipelineBuilder(dev, nstreams + 1, nbuf)
    panel_stream = nstreams

    # buffer-parity release ledger: events that must precede reuse of a key
    release: Dict[Tuple[str, int], Tuple[Event, ...]] = {}
    # previous trailing stage's host writes: (rows, cols, wC event)
    stage_writes: List[Tuple[Tuple[int, int], Tuple[int, int], Event]] = []
    gstep = 0  # global trailing step counter (stream round robin)

    # Fr residency: identity (stage, block row) — its slice depends only on
    # the row extent, so same-row blocks across columns share one transfer
    fr_cache = BlockCache(
        "Fr", nbuf, evict,
        [(k, blk[0]) for k, blk in _trailing_emission_order(spec)])
    fr_pos = 0
    fr_inc: Dict[Tuple[int, int], int] = {}

    def waits_for(key, *events: Iterable[Event]) -> Tuple[Event, ...]:
        out: Dict[str, Event] = {}
        for ev in release.pop(key, ()):
            out[ev.name] = ev
        for group in events:
            for ev in group:
                out[ev.name] = ev
        return tuple(out.values())

    def overlapping(rows, cols) -> List[Event]:
        return [ev for wr, wc, ev in stage_writes + new_writes
                if _hits(wr, rows[0], rows[0] + rows[1])
                and _hits(wc, cols[0], cols[0] + cols[1])]

    def emit_block(k: int, pw: int, blk) -> None:
        """One trailing-update block of stage ``k``: stream the multiplier
        slices and the C block, dgemm, write back."""
        nonlocal gstep, fr_pos
        i, j, rows, cols = blk
        k0, k1 = spec.panel_range(k)
        s = gstep % nstreams
        h_k = math.ceil((n - k1) / spec.bm)
        idx = j * h_k + i
        # left multiplier: rows of the factored panel (the A/Pr role) —
        # cached per (stage, block row), so only the row's first emitted
        # block transfers while it stays resident
        fr_id = (k, i)
        lslot, fr_hit, fr_evict = fr_cache.access(fr_pos, fr_id,
                                                  rows[1] * pw * bpe)
        fr_pos += 1
        lkey = ("Fr", lslot)
        if not fr_hit:
            inc = fr_inc.get(fr_id, 0)
            fr_inc[fr_id] = inc + 1
            suffix = "" if inc == 0 else f"@{inc}"
            landing = b.event(f"rFr{k}[r{i}]{suffix}")
            fr_cache.set_landing(fr_id, landing)
            fr_waits: Dict[str, Event] = {e.name: e for e in fr_evict}
            for e in overlapping(rows, (k0, pw)) + [b.event(f"wPNL[{k}]")]:
                fr_waits[e.name] = e
            b.issue(
                kind=OpKind.H2D, tag=f"S(fr{k}[r{i}]){suffix}", stream=s,
                waits=tuple(fr_waits.values()),
                records=landing,
                buffers_written=(lkey,), bytes=rows[1] * pw * bpe,
                payload=SliceRef("A", i, rows=rows, cols=(k0, pw)))
        # right multiplier, once per column: transposed panel rows (SYRK) or
        # the U row panel slice (LU).  Keyed per (stage, column) — with the
        # Cholesky triangular skip a column's first *emitted* block need not
        # be block row 0.
        tkey = ("Ft", j % 2)
        fresh_ft = (k, j) not in ft_loaded
        if fresh_ft:
            ft_loaded.add((k, j))
            if lu:
                ft = SliceRef("A", j, rows=(k0, pw), cols=cols)
                ft_ev = overlapping((k0, pw), cols) + [b.event(f"wUR[{k}]")]
            else:
                ft = SliceRef("A", j, rows=cols, cols=(k0, pw),
                              transpose=True)
                ft_ev = overlapping(cols, (k0, pw)) + [b.event(f"wPNL[{k}]")]
            b.issue(
                kind=OpKind.H2D, tag=f"S(ft{k}[{j}])", stream=s,
                waits=waits_for(tkey, ft_ev),
                records=b.event(f"rFt{k}[{j}]"),
                buffers_written=(tkey,), bytes=pw * cols[1] * bpe,
                payload=ft)
        ckey = ("C", idx % nbuf)
        # LU: the swap replay permuted these rows on host, so the C block
        # must not be read before the panel write-back (Cholesky's panel
        # write region is disjoint from the trailing square).
        c_extra = (b.event(f"wPNL[{k}]"),) if lu else ()
        b.issue(
            kind=OpKind.H2D, tag=f"S(c{k}[{idx}])", stream=s,
            waits=waits_for(ckey, overlapping(rows, cols), c_extra),
            records=b.event(f"rC{k}[{idx}]"),
            buffers_written=(ckey,), bytes=rows[1] * cols[1] * bpe,
            payload=SliceRef("A", idx, rows=rows, cols=cols))
        b.issue(
            kind=OpKind.COMPUTE, tag=f"{'GEMM' if lu else 'SYRK'}{k}[{idx}]",
            stream=s,
            waits=(fr_cache.landing_event(fr_id), b.event(f"rFt{k}[{j}]"),
                   b.event(f"rC{k}[{idx}]")),
            records=b.event(f"eT{k}[{idx}]"),
            buffers_read=(lkey, tkey), buffers_written=(ckey,),
            flops=2 * rows[1] * cols[1] * pw + 2 * rows[1] * cols[1],
            payload=BlockRef(kernel="dgemm", index=idx))
        wc = b.event(f"wC{k}[{idx}]")
        b.issue(
            kind=OpKind.D2H, tag=f"R(c{k}[{idx}])", stream=s,
            waits=(b.event(f"eT{k}[{idx}]"),), records=wc,
            buffers_read=(ckey,), bytes=rows[1] * cols[1] * bpe,
            payload=SliceRef("A", idx, rows=rows, cols=cols))
        # ledger updates: buffer reuse + host-region write
        fr_cache.note_release(fr_id, s, b.event(f"eT{k}[{idx}]"))
        keep = () if fresh_ft else release.get(tkey, ())
        release[tkey] = tuple(keep) + (b.event(f"eT{k}[{idx}]"),)
        release[ckey] = (wc,)
        new_writes.append((rows, cols, wc))
        gstep += 1

    rest: List = []          # deferred trailing blocks of the previous stage
    rest_stage = -1
    ft_loaded: set = set()   # (stage, column) pairs whose Ft slice landed
    new_writes: List[Tuple[Tuple[int, int], Tuple[int, int], Event]] = []

    for k in range(npanels):
        k0, k1 = spec.panel_range(k)
        pw = k1 - k0
        m = n - k0
        key = ("PNL", k % npbuf)
        s = panel_stream
        # ---- panel front: transfer + in-core factor --------------------
        if lookahead == 0:
            # sequential per-panel loop: the panel waits for every trailing
            # write-back of the previous stage (all still in new_writes —
            # stage k-1 emits in full before this panel)
            dep = [ev for _, _, ev in stage_writes + new_writes]
        else:
            dep = overlapping((k0, m), (k0, pw))
        b.issue(
            kind=OpKind.H2D, tag=f"S(pnl[{k}])", stream=s,
            waits=waits_for(key, dep),
            records=b.event(f"rPNL[{k}]"),
            buffers_written=(key,), bytes=m * pw * bpe,
            payload=SliceRef("A", k, rows=(k0, m), cols=(k0, pw)))
        b.issue(
            kind=OpKind.COMPUTE, tag=f"{'GETRF' if lu else 'POTRF'}[{k}]",
            stream=s,
            waits=(b.event(f"rPNL[{k}]"),), records=b.event(f"ePF[{k}]"),
            buffers_read=(key,), buffers_written=(key,),
            flops=(pw * pw * (3 * m - pw) // 3 if lu
                   else pw * pw * pw // 3),
            payload=BlockRef(kernel="panel_lu" if lu else "panel_chol",
                             index=k))
        last = b.event(f"ePF[{k}]")
        if not lu and m > pw:
            b.issue(
                kind=OpKind.COMPUTE, tag=f"TRSM[{k}]", stream=s,
                waits=(last,), records=b.event(f"eTS[{k}]"),
                buffers_read=(key,), buffers_written=(key,),
                flops=(m - pw) * pw * pw,
                payload=BlockRef(kernel="panel_trsm", index=k))
            last = b.event(f"eTS[{k}]")
        if not lu:
            # Cholesky's panel chain is independent of the previous stage's
            # remaining blocks: write it back before draining them so the
            # next trailing stage can start the moment its inputs land.
            b.issue(
                kind=OpKind.D2H, tag=f"R(pnl[{k}])", stream=s,
                waits=(last,), records=b.event(f"wPNL[{k}]"),
                buffers_read=(key,), bytes=m * pw * bpe,
                payload=SliceRef("A", k, rows=(k0, m), cols=(k0, pw)))
            release[key] = (b.event(f"wPNL[{k}]"),)
        # ---- drain the previous stage's deferred trailing blocks -------
        if rest:
            rpw = spec.panel_range(rest_stage)[1] - \
                spec.panel_range(rest_stage)[0]
            for blk in rest:
                emit_block(rest_stage, rpw, blk)
            rest = []
        if lu:
            # ---- panel back: swap replay + U row panel solve -----------
            # the replay permutes rows across the whole trailing region, so
            # it orders after every write-back of the previous stage
            wb_waits = {b.event(f"ePF[{k}]").name: b.event(f"ePF[{k}]")}
            for _, _, ev in stage_writes + new_writes:
                wb_waits[ev.name] = ev
            b.issue(
                kind=OpKind.D2H, tag=f"R(pnl[{k}])", stream=s,
                waits=tuple(wb_waits.values()),
                records=b.event(f"wPNL[{k}]"),
                buffers_read=(key,), bytes=m * pw * bpe,
                payload=BlockRef(kernel="lu_writeback", index=k))
            release[key] = (b.event(f"wPNL[{k}]"),)
            if m > pw:
                ukey = ("UR", k % npbuf)
                b.issue(
                    kind=OpKind.H2D, tag=f"S(ur[{k}])", stream=s,
                    waits=waits_for(ukey, (b.event(f"wPNL[{k}]"),)),
                    records=b.event(f"rUR[{k}]"),
                    buffers_written=(ukey,), bytes=pw * (n - k1) * bpe,
                    payload=SliceRef("A", k, rows=(k0, pw),
                                     cols=(k1, n - k1)))
                b.issue(
                    kind=OpKind.COMPUTE, tag=f"TRSM[{k}]", stream=s,
                    waits=(b.event(f"rUR[{k}]"), b.event(f"ePF[{k}]")),
                    records=b.event(f"eTS[{k}]"),
                    buffers_read=(key, ukey), buffers_written=(ukey,),
                    flops=(n - k1) * pw * pw,
                    payload=BlockRef(kernel="lu_trsm", index=k))
                b.issue(
                    kind=OpKind.D2H, tag=f"R(ur[{k}])", stream=s,
                    waits=(b.event(f"eTS[{k}]"),),
                    records=b.event(f"wUR[{k}]"),
                    buffers_read=(ukey,), bytes=pw * (n - k1) * bpe,
                    payload=SliceRef("A", k, rows=(k0, pw),
                                     cols=(k1, n - k1)))
                release[ukey] = (b.event(f"wUR[{k}]"),)
                release[key] = (b.event(f"wPNL[{k}]"),
                                b.event(f"eTS[{k}]"))
        # stage k-1 is fully emitted: its writes (plus this panel's) become
        # the overlap ledger for stage k's reads
        stage_writes = new_writes
        new_writes = []
        # ---- trailing update of stage k --------------------------------
        prio, rest = _stage_split(spec, k)
        rest_stage = k
        for blk in prio:
            emit_block(k, pw, blk)
    # the last stage's deferred blocks (none: the final panel drains them)
    assert not rest, "internal: trailing blocks left unemitted"
    assert fr_pos == len(fr_cache.next_use), \
        "internal: emission diverged from the residency pre-pass"
    b.sched.meta = {"evict": evict, "kind": spec.kind,
                    "kernel": f"{spec.kind}-factor"}
    b.sched.reuse = {"Fr": fr_cache.stats()}
    return b.sched
def build_gemm_schedule(
    part: GemmPartition,
    nstreams: int = 2,
    nbuf: int = 2,
    write_back: bool = True,
    device: Optional[Device] = None,
    traversal: str = "col",
    evict: str = "lru",
    fill_c: bool = False,
) -> Schedule:
    """Emit the MMOOC schedule of libhclooc Fig. 2 for ``part``;
    ``fill_c`` makes C's blocks on the device (:func:`gemm_pipeline_spec`).
    """
    spec = gemm_pipeline_spec(part, write_back=write_back,
                              traversal=traversal, band=nbuf, fill_c=fill_c)
    return compile_pipeline(spec, nstreams=nstreams, nbuf=nbuf,
                            device=device, evict=evict)


def build_attention_schedule(
    part: AttentionPartition,
    kv_heads: int,
    head_dim: int,
    q_heads: int,
    nstreams: int = 2,
    nbuf: int = 2,
    device: Optional[Device] = None,
) -> Schedule:
    """OOC attention schedule: KV blocks + online-softmax carry."""
    spec = attention_pipeline_spec(part, kv_heads, head_dim, q_heads)
    return compile_pipeline(spec, nstreams=nstreams, nbuf=nbuf, device=device)


def build_syrk_schedule(
    part: GemmPartition,
    nstreams: int = 2,
    nbuf: int = 2,
    device: Optional[Device] = None,
    traversal: str = "col",
    evict: str = "lru",
) -> Schedule:
    """Blocked SYRK schedule (Cholesky trailing update)."""
    return compile_pipeline(syrk_pipeline_spec(part, traversal=traversal,
                                               band=nbuf),
                            nstreams=nstreams, nbuf=nbuf,
                            device=device, evict=evict)


def build_vendor_schedule(
    part: GemmPartition,
    device: Optional[Device] = None,
    tile: int = 512,
) -> Schedule:
    """CUBLAS-XT-style baseline: one stream, B re-sent per tile, no overlap."""
    return compile_pipeline(vendor_pipeline_spec(part, tile=tile),
                            nstreams=1, nbuf=1, device=device)


def op_catalog(sched: Schedule) -> list:
    """Flat schedule-addressable op listing, one row per op in global
    issue order — the addressing surface fault plans (``repro_torch.fault``)
    and debugging tools key on.  ``op`` is the index a
    :class:`~repro_torch.fault.FaultSpec` targets; ``kernel`` names the compute
    / finalize handler (None for slice transfers) and ``operand`` the
    host array a slice ref touches (None for block refs)."""
    rows = []
    for i, op in enumerate(sched.ops):
        ref = op.payload
        rows.append({
            "op": i,
            "kind": op.kind.name.lower(),
            "stream": op.stream,
            "tag": op.tag,
            "kernel": ref.kernel if isinstance(ref, BlockRef) else None,
            "operand": getattr(ref, "operand", None),
            "bytes": op.bytes,
            "flops": op.flops,
        })
    return rows


def schedule_stats(sched: Schedule) -> dict:
    """Summary counters used by benchmarks and EXPERIMENTS.md."""
    return {
        "n_ops": len(sched.ops),
        "n_streams": len(sched.streams),
        "h2d_bytes": sched.total_bytes(OpKind.H2D),
        "d2h_bytes": sched.total_bytes(OpKind.D2H),
        "flops": sched.total_flops(),
        "n_events": sum(1 for o in sched.ops if o.records is not None),
        "reuse_hits": sum(r["hits"] for r in sched.reuse.values()),
        "h2d_saved_bytes": sum(r["bytes_saved"]
                               for r in sched.reuse.values()),
    }
