"""The port's partitioner: the twins of ``tests/test_partitioner.py``.

Each draw goes through the reference first: the port must refuse exactly
where it refuses (same error) and otherwise return the same partition,
field for field, on which the reference test's invariants are then
checked.
"""

import dataclasses

import numpy as np
import pytest
from tests._hypothesis_shim import given, settings, st

import repro.core.partitioner as R
from repro.core.api import hclMatrixPartitioner as R_facade
import repro_torch.core.partitioner as T
from repro_torch.core.api import hclMatrixPartitioner as T_facade

dims = st.integers(min_value=1, max_value=4096)


def _both(fn, *args, **kw):
    """(reference, port) results of ``fn`` in each partitioner module, or
    (None, None) when both refuse with the same message."""
    try:
        ref = getattr(R, fn)(*args, **kw)
    except ValueError as exc:
        with pytest.raises(ValueError) as texc:
            getattr(T, fn)(*args, **kw)
        assert str(texc.value) == str(exc)
        return None, None
    port = getattr(T, fn)(*args, **kw)
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    return ref, port


@given(M=dims, N=dims, K=dims,
       budget_kb=st.integers(min_value=64, max_value=1 << 16))
@settings(max_examples=200, deadline=None)
def test_partition_fits_budget_and_covers(M, N, K, budget_kb):
    budget = budget_kb * 1024
    _, part = _both("plan_gemm_partition", M, N, K, budget, bytes_per_el=4)
    if part is None:
        # must only refuse when even the minimal aligned working set is over
        minimal = T.GemmPartition(M, N, K, 0, 0, 8, 128, 4, budget)
        assert minimal.working_set_bytes() > budget
        return
    # invariant 1: the paper's 2-deep working set fits
    assert part.working_set_bytes() <= budget
    # invariant 2: blocks tile C exactly, in column-major order, no overlap
    seen = np.zeros((M, N), dtype=bool)
    last = (-1, -1)
    for i, j, rs, rn, cs, cn in part.blocks():
        assert (j, i) > last, "not column-major"
        last = (j, i)
        assert rn > 0 and cn > 0
        assert not seen[rs:rs + rn, cs:cs + cn].any(), "overlap"
        seen[rs:rs + rn, cs:cs + cn] = True
    assert seen.all(), "C not covered"
    # invariant 3: alignment (except boundary blocks)
    assert part.bm % 8 == 0 and part.bn % 128 == 0


@given(S=st.integers(min_value=1, max_value=1 << 20),
       kv=st.sampled_from([1, 2, 4, 8, 32]),
       d=st.sampled_from([64, 128]),
       budget_mb=st.integers(min_value=1, max_value=128))
@settings(max_examples=100, deadline=None)
def test_attention_partition(S, kv, d, budget_mb):
    budget = budget_mb * 2**20
    per_pos = 2 * kv * d * 2
    _, part = _both("plan_attention_partition", S, kv, d, budget,
                    bytes_per_el=2)
    if part is None:
        assert 2 * 128 * per_pos > budget
        return
    assert 2 * part.bs * per_pos <= budget          # double-buffered fit
    assert part.nblocks * part.bs >= S              # covers the cache
    assert part.bs % 128 == 0


def test_partition_prefers_balanced_blocks():
    _, part = _both("plan_gemm_partition", 4096, 4096, 1024, 32 * 2**20, 4)
    assert max(part.bm, part.bn) <= 8 * max(128, min(part.bm, part.bn))


def test_in_core_single_block():
    _, part = _both("plan_gemm_partition", 256, 256, 256, 1 << 30, 4)
    assert part.nblocks == 1


# ------------------------------------------------------------- edge cases
def test_unaligned_dims_cover_exactly():
    """Boundary blocks shrink to the ragged edge; interior stays aligned."""
    M, N, K = 1000, 999, 130
    ref, part = _both("plan_gemm_partition", M, N, K, 600_000, 4)
    assert part.bm % 8 == 0 and part.bn % 128 == 0
    rows = sum(part.block_rows(i)[1] for i in range(part.h))
    cols = sum(part.block_cols(j)[1] for j in range(part.w))
    assert rows == M and cols == N
    _, last_rn = part.block_rows(part.h - 1)
    _, last_cn = part.block_cols(part.w - 1)
    assert 0 < last_rn <= part.bm and 0 < last_cn <= part.bn
    assert list(part.blocks()) == list(ref.blocks())


def test_budget_exactly_at_minimum_working_set():
    """The planner accepts a budget equal to the minimum aligned working
    set and rejects one byte less, with the reference's message."""
    M, N, K, bpe = 64, 512, 256, 4
    minimal = T.GemmPartition(M, N, K, 0, 0, 8, 128, bpe, 0)
    floor = minimal.working_set_bytes()
    assert floor == R.GemmPartition(M, N, K, 0, 0, 8, 128, bpe,
                                    0).working_set_bytes()
    _, part = _both("plan_gemm_partition", M, N, K, floor, bpe)
    assert (part.bm, part.bn) == (8, 128)
    assert part.working_set_bytes() == floor
    with pytest.raises(ValueError, match="cannot fit"):
        T.plan_gemm_partition(M, N, K, floor - 1, bpe)
    assert _both("plan_gemm_partition", M, N, K, floor - 1, bpe) \
        == (None, None)


def test_attention_partition_at_align_boundary():
    kv, d, bpe = 4, 64, 2
    per_pos = 2 * kv * d * bpe
    floor = 2 * 128 * per_pos          # double-buffered minimum block pair
    _, part = _both("plan_attention_partition", 128, kv, d, floor, bpe)
    assert part.bs == 128 and part.nblocks == 1
    with pytest.raises(ValueError, match="exceeds budget"):
        T.plan_attention_partition(128, kv, d, floor - 1, bpe)
    assert _both("plan_attention_partition", 128, kv, d, floor - 1, bpe) \
        == (None, None)
    # one position past the alignment boundary rolls to a second block
    _, part = _both("plan_attention_partition", 129, kv, d, floor, bpe)
    assert part.bs == 128 and part.nblocks == 2
    assert part.nblocks * part.bs >= 129


# ---------------------------------------------- generalized working set
def _pair(*fields):
    return R.GemmPartition(*fields), T.GemmPartition(*fields)


def test_working_set_default_is_legacy_two_deep():
    ref, part = _pair(1024, 1024, 512, 8, 8, 128, 128, 4, 1 << 30)
    legacy = (2 * 128 * 512 + 512 * 128 + 2 * 128 * 128) * 4
    assert part.working_set_bytes() == ref.working_set_bytes() == legacy


def test_working_set_scales_with_nbuf():
    ref, part = _pair(1024, 1024, 512, 8, 8, 128, 128, 4, 1 << 30)
    # nbuf A slices + 2-deep B ping-pong + nbuf C blocks
    for nbuf in (1, 2, 3, 4):
        want = (nbuf * 128 * 512 + 2 * 512 * 128 + nbuf * 128 * 128) * 4
        assert part.working_set_bytes(nbuf=nbuf) == want
        assert ref.working_set_bytes(nbuf=nbuf) == want
    assert part.working_set_bytes(nbuf=3) > part.working_set_bytes(nbuf=2)
    # a single-column partition can't ping-pong B deeper than w
    one_ref, one_col = _pair(1024, 128, 512, 8, 1, 128, 128, 4, 1 << 30)
    assert one_col.working_set_bytes(nbuf=2) \
        == one_ref.working_set_bytes(nbuf=2) \
        == (2 * 128 * 512 + 512 * 128 + 2 * 128 * 128) * 4
    # only nstreams given: canonical nbuf = nstreams pairing
    for ns in (1, 2, 3):
        assert part.working_set_bytes(nstreams=ns) \
            == ref.working_set_bytes(nstreams=ns)
    assert part.working_set_bytes(nstreams=3) == \
        part.working_set_bytes(nbuf=3)
    assert part.working_set_bytes(nstreams=1) == \
        part.working_set_bytes(nbuf=2)
    with pytest.raises(ValueError, match="depth") as texc:
        part.working_set_bytes(nbuf=0)
    with pytest.raises(ValueError) as rexc:
        ref.working_set_bytes(nbuf=0)
    assert str(texc.value) == str(rexc.value)


def test_planner_threads_nbuf_through():
    """A budget the legacy model accepts can overflow a 3-deep pipeline;
    planning with nbuf=3 shrinks blocks until the deeper allocation
    fits, to the reference's partition."""
    M, N, K, bpe = 4096, 4096, 2048, 4
    budget = (M * K + K * N + M * N) * bpe // 5
    _, legacy = _both("plan_gemm_partition", M, N, K, budget, bpe)
    assert legacy.working_set_bytes() <= budget
    assert legacy.working_set_bytes(nbuf=3) > budget  # the overflow
    _, deep = _both("plan_gemm_partition", M, N, K, budget, bpe, nbuf=3)
    assert deep.working_set_bytes(nbuf=3) <= budget
    assert deep.bm * deep.bn < legacy.bm * legacy.bn


def test_facade_partitioner_accepts_pipeline_shape():
    M, N, K = 4096, 4096, 2048
    budget = (M * K + K * N + M * N) * 4 // 5
    legacy = T_facade(M, N, K, budget)
    deep = T_facade(M, N, K, budget, nbuf=3, nstreams=2)
    assert dataclasses.astuple(legacy) \
        == dataclasses.astuple(R_facade(M, N, K, budget))
    assert dataclasses.astuple(deep) == dataclasses.astuple(
        R_facade(M, N, K, budget, nbuf=3, nstreams=2))
    assert deep.working_set_bytes(nbuf=3, nstreams=2) <= budget
    assert deep.nblocks >= legacy.nblocks
