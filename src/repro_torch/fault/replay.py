"""Static redo-set derivation from the schedule's event DAG (§12).

Port of ``src/repro/fault/replay.py``, a copy apart from its
imports, held against it by ``tests/test_torch_fault.py`` and
``tests/test_torch_fault_fuzz.py``.

The executor recovers a compute fault dynamically (it keeps, per parity
buffer, the value at the last host-consistent point plus the compute
chain applied since).  Because the schedule is static, the same redo-set
is derivable *offline* from the op list alone: walk back from the faulted
op to its written buffer's last host-consistent point — an H2D load into
the buffer, or a slice write-back reading it (the "last completed
write-back") — and collect the computes that wrote the buffer since.

That makes the recovery cost analyzable before running anything:
:func:`redo_cost` prices a fault at any op under an engine model, and the
conformance tests assert the executor's dynamic chains match this static
derivation exactly.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.streams import BlockRef, OpKind, Schedule


def redo_set(sched: Schedule, op_index: int) -> List[int]:
    """Op indices re-executed if ``op_index``'s output block is lost.

    The last entry is ``op_index`` itself; the preceding entries are the
    compute chain (in issue order) that rebuilds the block's value at the
    fault point from its last host-consistent snapshot.  Raises for ops
    that are not single-writer computes — those are not replayable and
    have no redo-set.
    """
    op = sched.ops[op_index]
    if op.kind != OpKind.COMPUTE or len(op.buffers_written) != 1:
        raise ValueError(
            f"op {op_index} ({op.tag}) is not a single-writer compute; "
            f"redo-sets exist only for replayable computes")
    key = op.buffers_written[0]
    start = -1
    for j in range(op_index - 1, -1, -1):
        oj = sched.ops[j]
        if oj.kind == OpKind.H2D and key in oj.buffers_written:
            start = j
            break
        if (oj.kind == OpKind.D2H and key in oj.buffers_read
                and not isinstance(oj.payload, BlockRef)):
            start = j
            break
    redo = [j for j in range(start + 1, op_index)
            if sched.ops[j].kind == OpKind.COMPUTE
            and key in sched.ops[j].buffers_written]
    return redo + [op_index]


def redo_cost(sched: Schedule, hw, op_index: int) -> float:
    """Modeled seconds to replay a compute fault at ``op_index`` under
    engine model ``hw`` (sum of the redo-set's op durations)."""
    return sum(hw.duration(sched.ops[j]) for j in redo_set(sched, op_index))


def mean_redo_len(sched: Schedule) -> float:
    """Average redo-set length over the schedule's replayable computes —
    the ``redo_factor`` a calibrated simulator FaultModel would use."""
    lens = []
    for i, op in enumerate(sched.ops):
        if op.kind == OpKind.COMPUTE and len(op.buffers_written) == 1 \
                and isinstance(op.payload, BlockRef):
            try:
                lens.append(len(redo_set(sched, i)))
            except ValueError:
                continue
    return sum(lens) / len(lens) if lens else 0.0
