"""Port of ``src/repro/core/partitioner.py`` (JAX-free), held against it by
``tests/test_torch_planning.py``; a copy of the reference apart from its
imports.

Block partitioner for out-of-core GEMM — the ``hclMatrixPartitioner`` analogue.

The paper's partitioner splits A (M×K) into ``h`` horizontal slices, B (K×N)
into ``w`` vertical slices, and C (M×N) into ``h×w`` rectangular blocks such
that *the data required for updating any two blocks of C in the same column is
small enough to fit in the accelerator's memory* (libhclooc §III, §V).  Two
C blocks must fit simultaneously because the double-buffered pipeline holds the
block being computed and the block being transferred at the same time.

TPU adaptation: the "accelerator memory" is a *tier budget* (VMEM for the
Pallas backend, a single chip's HBM for host streaming, per-shard HBM for the
mesh backend), and block edges are aligned to the MXU/VREG tiling
(lane=128, sublane=8) so that the in-core GEMM hits the systolic array at full
utilization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

# TPU tiling constants (fp32/bf16 lane/sublane granularity).
LANE = 128
SUBLANE = 8


@dataclasses.dataclass(frozen=True)
class GemmPartition:
    """A plan for C = alpha * A @ B + beta * C computed in h x w blocks.

    Attributes mirror the paper's notation:
      h: number of horizontal slices of A (and of C's rows)
      w: number of vertical slices of B (and of C's cols)
      bm, bn: block dims of a C block (last row/col blocks may be smaller)
      M, N, K: problem shape
      bytes_per_el: element size (the paper fixes double; we support any dtype)
      budget: memory budget in bytes that the working set must fit
    """

    M: int
    N: int
    K: int
    h: int
    w: int
    bm: int
    bn: int
    bytes_per_el: int
    budget: int

    @property
    def nblocks(self) -> int:
        return self.h * self.w

    def working_set_bytes(self, nbuf: Optional[int] = None,
                          nstreams: Optional[int] = None) -> int:
        """Bytes resident on-device for the pipeline holding this partition.

        With no arguments this is the paper's fixed 2-deep model: one A slice
        (bm x K) plus its double-buffered successor, one B slice (K x bn),
        and TWO C blocks (bm x bn) — the block being computed and the block
        in flight.

        Passing ``nbuf`` (and optionally ``nstreams``) switches to the
        allocation the compiled pipeline actually makes
        (:func:`~repro_torch.core.pipeline.compile_pipeline`): ``nbuf`` parity
        buffers for each of A and C, and a 2-deep B ping-pong regardless of
        pipeline depth (never deeper than the column count ``w``).  The
        executor allocates per parity class, so stream count adds no buffers
        — but a deeper round robin only pays off with buffers to land in, so
        when only ``nstreams`` is given the depth is ``max(2, nstreams)``:
        the pipeline's default double buffering, deepened if more streams
        demand more landing slots.  This is the model the planner must use
        to stop approving partitions an ``nbuf=3`` schedule overflows.
        """
        if nbuf is None and nstreams is None:
            a = 2 * self.bm * self.K      # current + prefetched A slice
            b = self.K * self.bn          # one B slice (reused down a column)
            c = 2 * self.bm * self.bn     # two C blocks (paper's constraint)
            return (a + b + c) * self.bytes_per_el
        depth = nbuf if nbuf is not None else max(2, nstreams)
        if depth < 1:
            raise ValueError(f"buffer depth must be >= 1, got {depth}")
        b_depth = min(2, self.w) if self.w > 0 else 2
        a = depth * self.bm * self.K
        b = b_depth * self.K * self.bn
        c = depth * self.bm * self.bn
        return (a + b + c) * self.bytes_per_el

    def block_rows(self, i: int) -> Tuple[int, int]:
        """(row_start, row_size) of block row i, i in [0, h)."""
        start = i * self.bm
        return start, min(self.bm, self.M - start)

    def block_cols(self, j: int) -> Tuple[int, int]:
        start = j * self.bn
        return start, min(self.bn, self.N - start)

    def blocks(self):
        """Iterate (i, j, rs, rn, cs, cn) in the paper's column-major order.

        The paper's Fig. 2 loop iterates ``for j in range(w): for i in
        range(h)`` so that a B slice b_j is transferred once and reused for all
        h C blocks in its column.
        """
        for j in range(self.w):
            for i in range(self.h):
                rs, rn = self.block_rows(i)
                cs, cn = self.block_cols(j)
                yield i, j, rs, rn, cs, cn


# ---------------------------------------------------------------------------
# Traversal orders — the lever that controls operand reuse distance
# ---------------------------------------------------------------------------
# The paper's Fig. 2 fixes column-major order (B transfers once per column).
# With a residency-tracking compiler (pipeline.BlockCache) the traversal
# decides which recurrences land inside the cache capacity: serpentine keeps
# the A row live across a column boundary, a blocked band of height <= nbuf
# keeps every A row of the band live for the whole sweep, Z-Morton is the
# cache-oblivious compromise when nbuf is unknown.
TRAVERSALS = ("col", "row", "serpentine", "blocked", "zmorton")


def _morton_key(i: int, j: int) -> int:
    key = 0
    for bit in range(max(i.bit_length(), j.bit_length(), 1)):
        key |= ((i >> bit) & 1) << (2 * bit + 1)
        key |= ((j >> bit) & 1) << (2 * bit)
    return key


def traversal_order(h: int, w: int, traversal: str = "col",
                    band: Optional[int] = None) -> List[Tuple[int, int]]:
    """Visit order of the ``h x w`` C-block grid as ``(i, j)`` pairs.

    * ``col``        — the paper's order: ``for j: for i``.
    * ``row``        — ``for i: for j`` (B-heavy; useful when h < w).
    * ``serpentine`` — column-major with alternating row direction, so the
      A row at each column boundary repeats back-to-back.
    * ``blocked``    — row bands of height ``band`` (default 2), columns
      swept serpentine *across bands*: with ``band <= nbuf`` every A row of
      a band stays resident for its whole sweep, and the B ping-pong hits
      at each band boundary.
    * ``zmorton``    — cells sorted by bit-interleaved (i, j): bounded reuse
      distance in both operands without knowing the buffer depth.

    Every order is a permutation of the grid, so the set of computed blocks
    (and the result) is identical; only transfer traffic changes.
    """
    if h < 1 or w < 1:
        raise ValueError(f"bad grid {h}x{w}")
    if traversal == "col":
        return [(i, j) for j in range(w) for i in range(h)]
    if traversal == "row":
        return [(i, j) for i in range(h) for j in range(w)]
    if traversal == "serpentine":
        out: List[Tuple[int, int]] = []
        for j in range(w):
            rng = range(h) if j % 2 == 0 else range(h - 1, -1, -1)
            out.extend((i, j) for i in rng)
        return out
    if traversal == "blocked":
        b = max(1, band or 2)
        out = []
        for nb, b0 in enumerate(range(0, h, b)):
            i_rng = range(b0, min(b0 + b, h))
            j_rng = range(w) if nb % 2 == 0 else range(w - 1, -1, -1)
            for j in j_rng:
                out.extend((i, j) for i in i_rng)
        return out
    if traversal == "zmorton":
        return sorted(((i, j) for i in range(h) for j in range(w)),
                      key=lambda ij: _morton_key(*ij))
    raise ValueError(
        f"unknown traversal {traversal!r}; expected one of {TRAVERSALS}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _align_block(b: int, dim: int, align: int) -> int:
    """Round block size up to ``align`` without exceeding the padded dim."""
    b = max(align, _round_up(b, align))
    return min(b, _round_up(dim, align))


def plan_gemm_partition(
    M: int,
    N: int,
    K: int,
    budget_bytes: int,
    bytes_per_el: int = 4,
    align_m: int = SUBLANE,
    align_n: int = LANE,
    nbuf: Optional[int] = None,
    nstreams: Optional[int] = None,
) -> GemmPartition:
    """Choose (h, w) so the pipeline working set fits ``budget_bytes``.

    Strategy (faithful to the paper, §V): keep K un-split (slices of A are
    full-K rows, slices of B are full-K columns) and grow h and w until the
    working set fits.  Prefer fewer, larger blocks (maximize in-core GEMM
    efficiency) and prefer splitting M before N, because a B slice is reused
    ``h`` times per column while an A slice is used once — smaller bn raises
    B-transfer cost linearly, smaller bm only shrinks the compute tile.

    ``nbuf``/``nstreams`` select the generalized working-set model of
    :meth:`GemmPartition.working_set_bytes` so a deeper pipeline (nbuf > 2)
    gets correspondingly smaller blocks instead of overflowing the budget;
    the default (both None) keeps the paper's fixed 2-deep model.

    Raises ValueError if even the minimum aligned block does not fit — the
    paper's implicit requirement that K itself fits (it never splits K; our
    Pallas backend *does* split K, see kernels/block_matmul.py, which is a
    beyond-paper extension).
    """
    if min(M, N, K) <= 0:
        raise ValueError(f"bad GEMM shape {(M, N, K)}")
    if budget_bytes <= 0:
        raise ValueError("budget must be positive")

    def probe(bm: int, bn: int) -> GemmPartition:
        # carries the real (h, w): the generalized model caps the B
        # ping-pong at the column count, so a single-column partition must
        # not be charged for two B slices
        return GemmPartition(M, N, K, math.ceil(M / bm), math.ceil(N / bn),
                             bm, bn, bytes_per_el, budget_bytes)

    def fits(bm: int, bn: int) -> bool:
        return probe(bm, bn).working_set_bytes(nbuf, nstreams) <= budget_bytes

    # Start in-core: one block covering everything.
    bm = _align_block(M, M, align_m)
    bn = _align_block(N, N, align_n)

    # Shrink the larger block dim first (balanced splitting keeps the in-core
    # GEMM tile fat for the MXU); ties prefer splitting M, because a B slice
    # is reused h times per column while an A slice is used once.
    min_bm, min_bn = align_m, align_n
    while not fits(bm, bn):
        shrink_m = (bm >= bn and bm > min_bm) or bn <= min_bn
        if shrink_m and bm > min_bm:
            target = max(min_bm, _round_up(bm // 2, align_m))
            bm = target if target < bm else bm - align_m
        elif bn > min_bn:
            target = max(min_bn, _round_up(bn // 2, align_n))
            bn = target if target < bn else bn - align_n
        else:
            need = probe(bm, bn).working_set_bytes(nbuf, nstreams)
            raise ValueError(
                f"GEMM {(M, N, K)} cannot fit budget {budget_bytes}B: minimum "
                f"aligned working set is {need}B (K is never split by the "
                f"paper's partitioner; use the vmem backend for K-splitting)"
            )

    h = math.ceil(M / bm)
    w = math.ceil(N / bn)
    return GemmPartition(M, N, K, h, w, bm, bn, bytes_per_el, budget_bytes)


@dataclasses.dataclass(frozen=True)
class AttentionPartition:
    """KV-cache block plan for out-of-core attention (beyond-paper).

    The same budget math applied to attention: queries stay resident, the KV
    cache (S × kv_heads × head_dim, ×2 for K and V) is streamed in ``nblocks``
    sequence blocks of ``bs`` positions each.
    """

    S: int
    bs: int
    nblocks: int
    bytes_per_el: int
    budget: int


def plan_attention_partition(
    seq_len: int,
    kv_heads: int,
    head_dim: int,
    budget_bytes: int,
    bytes_per_el: int = 2,
    align_s: int = LANE,
) -> AttentionPartition:
    """Pick a KV block length so 2 in-flight (K,V) blocks fit the budget."""
    if seq_len <= 0:
        raise ValueError("seq_len must be positive")
    per_pos = 2 * kv_heads * head_dim * bytes_per_el  # K and V
    bs = _round_up(seq_len, align_s)
    while bs > align_s and 2 * bs * per_pos > budget_bytes:
        bs = max(align_s, _round_up(bs // 2, align_s))
    if 2 * bs * per_pos > budget_bytes:
        raise ValueError(
            f"attention KV block of {align_s} positions "
            f"({2 * align_s * per_pos}B double-buffered) exceeds budget "
            f"{budget_bytes}B"
        )
    nblocks = math.ceil(seq_len / bs)
    return AttentionPartition(seq_len, bs, nblocks, bytes_per_el, budget_bytes)
