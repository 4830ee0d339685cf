"""The benchmark's own count of a schedule's block products and transfers.

A ``dgemm`` op's shape is worked out from the slices that landed in its two
input buffers (``m x k`` and ``k x n``), as the schedule's transfer ops
describe them, and not taken from the op's own ``flops``.  The executor
records one span per op, in the schedule's op order, so span ``i`` times
op ``i``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from oocbench.harness.record import ExecRun


def slice_shape(ref, shapes) -> Tuple[int, int]:
    """The shape of a transfer's slice of its host operand."""
    rows, cols = shapes[ref.operand]
    r = ref.rows[1] if ref.rows is not None else rows
    c = ref.cols[1] if ref.cols is not None else cols
    return (c, r) if ref.transpose else (r, c)


def _kernel(op) -> Optional[str]:
    return getattr(op.payload, "kernel", None)


def block_products(er: ExecRun) -> Iterator[Tuple[int, int, int, int]]:
    """``(op index, m, n, k)`` of every ``dgemm`` op of the run; nothing
    for a schedule without one.  Only the slices that a ``dgemm`` op reads
    are shaped, so operands of other ranks (attention's K and V) pass."""
    landed = {}
    for i, op in enumerate(er.sched.ops):
        kind = op.kind.name
        if kind == "H2D" and _kernel(op) is None:
            landed[op.buffers_written[0]] = op.payload
        elif kind == "COMPUTE" and _kernel(op) == "dgemm":
            m, k = slice_shape(landed[op.buffers_read[0]], er.shapes)
            k2, n = slice_shape(landed[op.buffers_read[1]], er.shapes)
            if k != k2:
                raise ValueError(f"op {i} ({op.tag}): inner dims {k} and "
                                 f"{k2} differ")
            yield i, m, n, k


def product_flops(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def product_bytes(m: int, n: int, k: int, beta: float,
                  element_bytes: int) -> int:
    """Each input element read once, each output element written once
    (and read once where ``beta`` is not 0)."""
    return (m * k + k * n + m * n * (2 if beta else 1)) * element_bytes


def spans_of(er: ExecRun, ops: List[int]) -> Optional[float]:
    """Summed device seconds of the spans of ``ops``; None where the run
    recorded no span for each of its ops."""
    if len(er.spans) != len(er.sched.ops):
        return None
    return sum(er.spans[i][3] - er.spans[i][2] for i in ops)


def ops_where(er: ExecRun, kind: str, kernels=None) -> List[int]:
    """Indices of the ops of ``kind`` (``H2D``, ``D2H``, ``COMPUTE``),
    and with a kernel in ``kernels`` where given."""
    return [i for i, op in enumerate(er.sched.ops)
            if op.kind.name == kind
            and (kernels is None or _kernel(op) in kernels)]
