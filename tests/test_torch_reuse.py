"""Reuse-aware scheduling on the port: the twins of ``tests/test_reuse.py``.

Traversal orders, the compiler's block cache and its eviction event
wiring are planning code: the port's must equal the reference's (orders,
schedules op for op, ``Schedule.reuse`` counters, validator messages).
Execution runs on the port's executor on the CPU: every traversal x
eviction schedule bit for bit equal to the naive one, as the reference
asserts, and within the reference's fp32 tolerance of the reference's
result.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.convert import from_reference
from _torch_helpers import one_torch_thread, op_key  # noqa: F401

COMBOS = [(t, e) for t in T.TRAVERSALS for e in T.EVICT_POLICIES]
CPU = "cpu"


def test_policies_match_reference():
    assert T.TRAVERSALS == R.TRAVERSALS
    assert T.EVICT_POLICIES == R.EVICT_POLICIES


def _part(M, N, K, bm, bn, bpe=4, budget=1 << 22):
    return T.GemmPartition(M, N, K, -(-M // bm), -(-N // bn), bm, bn,
                           bpe, budget)


def _compile(spec_fn, part, *, nstreams, nbuf, evict="lru", **spec_kw):
    """The port's compiled schedule, held op for op (with its meta and
    cache counters) to the reference's from the same partition."""
    rpart = R.GemmPartition(*[getattr(part, f) for f in (
        "M", "N", "K", "h", "w", "bm", "bn", "bytes_per_el", "budget")])
    ref = R.compile_pipeline(getattr(R, spec_fn)(rpart, **spec_kw),
                             nstreams=nstreams, nbuf=nbuf, evict=evict)
    port = T.compile_pipeline(getattr(T, spec_fn)(part, **spec_kw),
                              nstreams=nstreams, nbuf=nbuf, evict=evict)
    assert [op_key(o) for o in port.ops] == [op_key(o) for o in ref.ops]
    assert port.meta == ref.meta and port.reuse == ref.reuse
    return ref, port


def _run(sched, operands, outputs, ctx):
    T.ScheduleExecutor(torch_device=CPU).run(sched, operands, outputs, ctx)


# ===========================================================================
# Traversal orders
# ===========================================================================
@pytest.mark.parametrize("traversal", T.TRAVERSALS)
@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (4, 4), (3, 5)])
def test_traversal_is_a_permutation(traversal, h, w):
    order = T.traversal_order(h, w, traversal, band=2)
    assert order == R.traversal_order(h, w, traversal, band=2)
    assert len(order) == h * w
    assert set(order) == {(i, j) for i in range(h) for j in range(w)}


def test_col_traversal_matches_paper_order():
    # the seed compiler's column-major sequence: j outer, i inner
    assert T.traversal_order(3, 2, "col") == [(0, 0), (1, 0), (2, 0),
                                              (0, 1), (1, 1), (2, 1)]


def test_unknown_traversal_names_the_valid_set():
    with pytest.raises(ValueError, match="col") as texc:
        T.traversal_order(2, 2, "diagonal")
    with pytest.raises(ValueError) as rexc:
        R.traversal_order(2, 2, "diagonal")
    assert str(texc.value) == str(rexc.value)


# ===========================================================================
# Every traversal x evict combination validates and is bitwise-identical
# ===========================================================================
@pytest.mark.parametrize("traversal,evict", COMBOS)
@pytest.mark.parametrize("nstreams,nbuf", [(1, 1), (2, 3)])
def test_gemm_schedules_validate(traversal, evict, nstreams, nbuf):
    part = _part(192, 192, 128, 64, 64)
    _, sched = _compile("gemm_pipeline_spec", part, nstreams=nstreams,
                        nbuf=nbuf, evict=evict, traversal=traversal,
                        band=nbuf)
    T.validate_schedule(sched)
    assert sched.meta["traversal"] == traversal
    assert sched.meta["evict"] == evict
    assert sched.meta["kernel"] == "gemm"   # obs label


@pytest.mark.parametrize("traversal,evict", COMBOS)
def test_gemm_bitwise_identical_to_naive(traversal, evict):
    part = _part(192, 192, 128, 64, 64)
    rng = np.random.default_rng(1)
    A = rng.standard_normal((192, 128)).astype(np.float32)
    B = rng.standard_normal((128, 192)).astype(np.float32)
    ctx = {"alpha": 1.0, "beta": 0.0}

    _, naive = _compile("gemm_pipeline_spec", part, nstreams=2, nbuf=2,
                        reuse=False)
    ref = torch.zeros(192, 192)
    _run(naive, {"A": A, "B": B}, {"C": ref}, ctx)

    rsched, sched = _compile("gemm_pipeline_spec", part, nstreams=2, nbuf=3,
                             evict=evict, traversal=traversal, band=3)
    out = torch.zeros(192, 192)
    _run(sched, {"A": A, "B": B}, {"C": out}, ctx)
    assert torch.equal(out, ref)
    rout = np.zeros((192, 192), np.float32)
    R.ScheduleExecutor().run(rsched, {"A": A, "B": B}, {"C": rout}, ctx)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("traversal,evict", COMBOS)
def test_syrk_bitwise_identical_to_naive(traversal, evict):
    part = _part(192, 192, 96, 64, 64)
    rng = np.random.default_rng(2)
    P = rng.standard_normal((192, 96)).astype(np.float32)
    ctx = {"alpha": -1.0, "beta": 1.0}
    C0 = rng.standard_normal((192, 192)).astype(np.float32)

    _, naive = _compile("syrk_pipeline_spec", part, nstreams=2, nbuf=2,
                        reuse=False)
    ref = torch.from_numpy(C0.copy())
    _run(naive, {"P": P}, {"C": ref}, ctx)

    rsched, sched = _compile("syrk_pipeline_spec", part, nstreams=2, nbuf=3,
                             evict=evict, traversal=traversal, band=3)
    out = torch.from_numpy(C0.copy())
    _run(sched, {"P": P}, {"C": out}, ctx)
    assert torch.equal(out, ref)
    rout = C0.copy()
    R.ScheduleExecutor().run(rsched, {"P": P}, {"C": rout}, ctx)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)


def _spd(seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((384, 384)).astype(np.float64)
    return X @ X.T + 384 * np.eye(384)


FACTOR_KW = dict(panel=128, budget_bytes=1 << 20, lookahead=1, validate=True)


@pytest.mark.parametrize("evict", T.EVICT_POLICIES)
def test_cholesky_bitwise_identical_across_evict(evict):
    A = _spd(3)
    ref = T.ooc_cholesky(A, torch_device=CPU, **FACTOR_KW)   # default lru
    out = T.ooc_cholesky(A, evict=evict, torch_device=CPU, **FACTOR_KW)
    assert torch.equal(out, ref)
    rout = np.asarray(R.ooc_cholesky(A, evict=evict, **FACTOR_KW))
    scale = np.abs(rout).max()
    np.testing.assert_allclose(out.numpy(), rout, rtol=0, atol=5e-6 * scale)


@pytest.mark.parametrize("evict", T.EVICT_POLICIES)
def test_lu_bitwise_identical_across_evict(evict):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((384, 384)).astype(np.float64) \
        + 384 * np.eye(384)
    ref_lu, ref_perm = T.ooc_lu(A, torch_device=CPU, **FACTOR_KW)
    out_lu, out_perm = T.ooc_lu(A, evict=evict, torch_device=CPU,
                                **FACTOR_KW)
    assert torch.equal(out_lu, ref_lu)
    assert torch.equal(out_perm, ref_perm)
    r_lu, r_perm = R.ooc_lu(A, evict=evict, **FACTOR_KW)
    assert np.array_equal(out_perm.numpy(), np.asarray(r_perm))
    r_lu = np.asarray(r_lu)
    np.testing.assert_allclose(out_lu.numpy(), r_lu, rtol=0,
                               atol=5e-6 * np.abs(r_lu).max())


# ===========================================================================
# Byte accounting: executor == simulate == stats, counters reconcile
# ===========================================================================
@pytest.mark.parametrize("traversal,evict", COMBOS)
def test_h2d_byte_counters_agree(traversal, evict):
    part = _part(192, 192, 128, 64, 64)
    rsched, sched = _compile("gemm_pipeline_spec", part, nstreams=2,
                             nbuf=3, evict=evict, traversal=traversal,
                             band=3)
    rng = np.random.default_rng(5)
    A = rng.standard_normal((192, 128)).astype(np.float32)
    B = rng.standard_normal((128, 192)).astype(np.float32)
    out = torch.zeros(192, 192)
    ex = T.ScheduleExecutor(torch_device=CPU)
    ex.run(sched, operands={"A": A, "B": B}, outputs={"C": out},
           ctx={"alpha": 1.0, "beta": 0.0})
    res = T.simulate(sched, T.gpu_like())
    rres = R.simulate(rsched, R.gpu_like())
    stats = T.schedule_stats(sched)
    assert ex.last_h2d_bytes == res.h2d_bytes == stats["h2d_bytes"]
    assert ex.last_d2h_bytes == res.d2h_bytes == stats["d2h_bytes"]
    assert (res.h2d_by_operand, res.reuse, res.hit_rate) \
        == (rres.h2d_by_operand, rres.reuse, rres.hit_rate)
    # per-operand splits and cache counters reconcile with the totals
    assert sum(res.h2d_by_operand.values()) == res.h2d_bytes
    assert sum(r["bytes_moved"] for r in res.reuse.values()) == res.h2d_bytes
    assert 0.0 <= res.hit_rate <= 1.0
    assert stats["reuse_hits"] == sum(r["hits"] for r in res.reuse.values())
    assert stats["h2d_saved_bytes"] == sum(
        r["bytes_saved"] for r in res.reuse.values())


def test_reuse_never_moves_more_bytes_than_naive():
    part = _part(512, 512, 256, 128, 128)
    naive = T.schedule_stats(_compile("gemm_pipeline_spec", part,
                                      nstreams=2, nbuf=3, reuse=False)[1])
    for traversal, evict in COMBOS:
        cached = T.schedule_stats(_compile(
            "gemm_pipeline_spec", part, nstreams=2, nbuf=3, evict=evict,
            traversal=traversal, band=3)[1])
        assert cached["h2d_bytes"] <= naive["h2d_bytes"]
    # and at least one traversal strictly reduces traffic on a 4x4 grid
    blocked = T.schedule_stats(_compile(
        "gemm_pipeline_spec", part, nstreams=2, nbuf=3,
        traversal="blocked", band=3)[1])
    assert blocked["h2d_bytes"] < naive["h2d_bytes"]
    assert blocked["reuse_hits"] > 0


def test_factor_fr_cache_hits_and_belady_not_worse():
    moved = {}
    for evict in T.EVICT_POLICIES:
        args = (768, 128, 1 << 20, 4)
        kw = dict(kind="cholesky", lookahead=1)
        sched = T.compile_factor_pipeline(T.factor_pipeline_spec(*args, **kw),
                                          nstreams=2, nbuf=2, evict=evict)
        ref = R.compile_factor_pipeline(R.factor_pipeline_spec(*args, **kw),
                                        nstreams=2, nbuf=2, evict=evict)
        assert [op_key(o) for o in sched.ops] == [op_key(o) for o in ref.ops]
        assert sched.reuse == ref.reuse
        T.validate_schedule(sched)
        assert sched.reuse["Fr"]["hits"] > 0
        moved[evict] = sched.reuse["Fr"]["bytes_moved"]
    # on a static schedule the MIN oracle never misses more than LRU
    assert moved["belady"] <= moved["lru"]


# ===========================================================================
# nstreams=1, nbuf=1 single-consumer eviction wiring, pinned
# ===========================================================================
def test_release_waits_single_stream_single_buffer():
    part = _part(128, 128, 64, 64, 64)        # 2x2 block grid
    _, sched = _compile("gemm_pipeline_spec", part, nstreams=1, nbuf=1)
    T.validate_schedule(sched)
    ops = {}
    for op in sched.ops:
        ops.setdefault(op.tag, []).append(op)

    def waits(tag, k=0):
        return tuple(ev.name for ev in ops[tag][k].waits)

    # col order: steps (0,0)(1,0)(0,1)(1,1); A ids 0,1,0,1; C ids 0,1,2,3.
    # With one A buffer, fetching A row 1 evicts row 0 — the eviction must
    # wait on row 0's single consumer, DGEMM step 0, and nothing else.
    assert waits("S(a[1])") == ("eA[0]",)
    # C is inout: replacing C block 0 must wait for its *write-back*.
    assert waits("S(c[1])") == ("wC[0]",)
    # B has its 2-deep ping-pong: both columns fit, so neither B transfer
    # carries eviction waits.
    assert waits("S(b[0])") == ()
    assert waits("S(b[1])") == ()
    # A row 0 returns at step 2: a fresh transfer under a distinct
    # incarnation tag/event, waiting on step 1.
    assert ops["S(a[0])"][0].records.name == "rA[0]"
    assert ops["S(a[0])@1"][0].records.name == "rA[0]@1"
    assert waits("S(a[0])@1") == ("eA[1]",)
    # B columns stay resident: exactly one transfer each, 2 cache hits
    assert sched.reuse["B"] == {
        "hits": 2, "misses": 2,
        "bytes_moved": 2 * 64 * 64 * 4, "bytes_saved": 2 * 64 * 64 * 4}


def test_nbuf1_gemm_executes_correctly():
    part = _part(128, 128, 64, 64, 64)
    rsched, sched = _compile("gemm_pipeline_spec", part, nstreams=1, nbuf=1)
    rng = np.random.default_rng(6)
    A = rng.standard_normal((128, 64)).astype(np.float32)
    B = rng.standard_normal((64, 128)).astype(np.float32)
    ctx = {"alpha": 1.0, "beta": 0.0}
    for mode in T.ScheduleExecutor.MODES:
        out = torch.zeros(128, 128)
        T.ScheduleExecutor(torch_device=CPU, mode=mode).run(
            sched, operands={"A": A, "B": B}, outputs={"C": out}, ctx=ctx)
        np.testing.assert_allclose(out.numpy(), A @ B, rtol=1e-4, atol=1e-4)
    rout = np.zeros((128, 128), np.float32)
    R.ScheduleExecutor().run(rsched, {"A": A, "B": B}, {"C": rout}, ctx)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)


# ===========================================================================
# validate_schedule error paths name op tag + buffer key
# ===========================================================================
def _rejected(build):
    """The port's validator message for ``build(T)``, after holding it
    equal to the reference's for ``build(R)``."""
    scheds = []
    for mod in (R, T):
        dev = mod.Device("HBM", 0, 1 << 20)
        sched = mod.Schedule(dev, mod.StreamFactory.create(dev, 2))
        build(mod, sched)
        scheds.append(sched)
    with pytest.raises(R.ScheduleError) as rexc:
        R.validate_schedule(scheds[0])
    with pytest.raises(T.ScheduleError) as texc:
        T.validate_schedule(scheds[1])
    assert str(texc.value) == str(rexc.value)
    return str(texc.value)


def test_overlap_error_names_both_ops_and_the_buffer():
    def build(mod, sched):
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(a[0])", stream=0,
                           records=mod.Event("rA[0]"),
                           buffers_written=(("A", 0),), bytes=4))
        # second transfer overwrites the same device buffer from the other
        # stream with no ordering edge — the classic double-buffering bug
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(a[1])", stream=1,
                           records=mod.Event("rA[1]"),
                           buffers_written=(("A", 0),), bytes=4))

    msg = _rejected(build)
    assert "S(a[0])" in msg and "S(a[1])" in msg
    assert "('A', 0)" in msg


def test_unordered_read_write_error_names_both_ops_and_the_buffer():
    def build(mod, sched):
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(a[0])", stream=0,
                           records=mod.Event("rA[0]"),
                           buffers_written=(("A", 0),), bytes=4))
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="DGEMM[0]",
                           stream=0, waits=(mod.Event("rA[0]"),),
                           records=mod.Event("eA[0]"),
                           buffers_read=(("A", 0),), flops=1))
        # refill from stream 1 without waiting on the reader
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(a[1])", stream=1,
                           waits=(mod.Event("rA[0]"),),
                           records=mod.Event("rA[1]"),
                           buffers_written=(("A", 0),), bytes=4))

    msg = _rejected(build)
    assert "DGEMM[0]" in msg and "S(a[1])" in msg
    assert "('A', 0)" in msg


def test_use_before_transfer_error_names_op_and_buffer():
    def build(mod, sched):
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="DGEMM[0]",
                           stream=0, records=mod.Event("eA[0]"),
                           buffers_read=(("A", 0),), flops=1))

    msg = _rejected(build)
    assert "DGEMM[0]" in msg
    assert "('A', 0)" in msg
    assert "use-before-transfer" in msg


# ===========================================================================
# Tuner integration: traversal/evict searched and recorded
# ===========================================================================
def test_search_records_traversal_and_evict():
    from repro.tune import gpu_profile as r_gpu_profile
    from repro.tune.search import search_gemm as r_search_gemm
    from repro_torch.tune import gpu_profile
    from repro_torch.tune.search import TunedPlan, search_gemm

    kw = dict(fingerprint="t", max_steps=256)
    plan = search_gemm(256, 256, 256, 1 << 20, gpu_profile(), **kw)
    ref = r_search_gemm(256, 256, 256, 1 << 20, r_gpu_profile(), **kw)
    assert plan.to_json() == ref.to_json()
    assert plan.traversal in T.TRAVERSALS
    assert plan.evict in T.EVICT_POLICIES
    back = TunedPlan.from_json(plan.to_json())
    assert back == plan
