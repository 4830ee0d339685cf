"""The port's ScheduleExecutor against the reference executor (CPU).

The same schedule runs through both: built by the port, or carried across
from the reference with ``from_reference``.  Outputs must match the
reference and the float64 oracle at ``test_oocgemm.py``'s tolerance (1e-4),
byte counters must equal ``schedule_stats`` exactly, and within the port
``issue_order``/``concurrent`` and ``async_writeback`` on/off must agree
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.convert import from_reference
from repro_torch.obs import get_observability
from _torch_helpers import (one_torch_thread,  # noqa: F401 (autouse)
                            op_key, overlap_schedule)

CPU = "cpu"


def _gemm_case(seed, M=320, N=256, K=192, frac=3, **build_kw):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    rpart = R.plan_gemm_partition(M, N, K, budget, 4)
    return A, B, C, rpart, R.build_gemm_schedule(rpart, **build_kw)


def _run_port(sched, operands, C, ctx, **ex_kw):
    ex = T.ScheduleExecutor(torch_device=CPU, **ex_kw)
    out = {"C": torch.from_numpy(np.array(C, copy=True))}
    ex.run(sched, operands, out, ctx)
    return out["C"].numpy(), ex


def _run_ref(sched, operands, C, ctx):
    out = {"C": np.array(C, copy=True)}
    R.ScheduleExecutor().run(sched, operands, out, ctx)
    return out["C"]


@pytest.mark.parametrize("nstreams,nbuf,traversal,evict", [
    (2, 2, "col", "lru"),
    (1, 1, "col", "lru"),
    (2, 3, "serpentine", "belady"),
    (3, 2, "row", "lru"),
    (2, 2, "blocked", "belady"),
    (1, 2, "zmorton", "lru"),
])
def test_gemm_schedule_matches_reference(nstreams, nbuf, traversal, evict):
    A, B, C, rpart, rsched = _gemm_case(
        nstreams * 10 + nbuf, nstreams=nstreams, nbuf=nbuf,
        traversal=traversal, evict=evict)
    tsched = T.build_gemm_schedule(
        from_reference(rpart), nstreams=nstreams, nbuf=nbuf,
        traversal=traversal, evict=evict)
    stats = T.schedule_stats(tsched)
    ctx = {"alpha": 1.5, "beta": 0.5}
    ref_out = _run_ref(rsched, {"A": A, "B": B}, C, ctx)
    oracle = 1.5 * (A.astype(np.float64) @ B) + 0.5 * C
    operands = {"A": from_reference(A), "B": from_reference(B)}
    assert torch.equal(operands["A"], torch.from_numpy(A))
    outs = []
    for sched in (tsched, from_reference(rsched)):
        for mode in ("issue_order", "concurrent"):
            for wb in (True, False):
                out, ex = _run_port(sched, operands, C, ctx,
                                    mode=mode, async_writeback=wb)
                assert ex.last_h2d_bytes == stats["h2d_bytes"]
                assert ex.last_d2h_bytes == stats["d2h_bytes"]
                assert ex.last_completion_order \
                    == list(range(len(sched.ops)))
                outs.append(out)
    for out in outs[1:]:
        assert np.array_equal(out, outs[0])
    np.testing.assert_allclose(outs[0], oracle, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0], ref_out, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("traversal", ["col", "row"])
def test_syrk_schedule_matches_reference(traversal):
    rng = np.random.default_rng(13)
    n, K = 256, 192
    P = rng.standard_normal((n, K)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    rpart = R.plan_gemm_partition(n, n, K, (2 * P.nbytes + C.nbytes) // 2,
                                  4, nbuf=2, nstreams=2)
    rsched = R.build_syrk_schedule(rpart, nstreams=2, nbuf=2,
                                   traversal=traversal)
    ctx = {"alpha": 1.0, "beta": 0.5}
    ref_out = _run_ref(rsched, {"P": P}, C, ctx)
    outs = [_run_port(from_reference(rsched), {"P": P}, C, ctx, mode=m)[0]
            for m in ("issue_order", "concurrent")]
    assert np.array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], P.astype(np.float64) @ P.T + 0.5 * C,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0], ref_out, rtol=1e-4, atol=1e-4)


def test_host_coherence_flushes_overlapping_writeback():
    rng = np.random.default_rng(21)
    A = rng.standard_normal((6, 8)).astype(np.float32)
    B = rng.standard_normal((8, 6)).astype(np.float32)
    C = rng.standard_normal((6, 6)).astype(np.float32)
    ctx = {"alpha": 1.0, "beta": 2.0}
    rsched = overlap_schedule(R)
    tsched = overlap_schedule(T)
    assert from_reference(rsched) == tsched
    T.validate_schedule(tsched)
    expect = C.astype(np.float64)
    ab = A.astype(np.float64) @ B
    expect[0:4] = ab[0:4] + 2.0 * expect[0:4]
    expect[2:6] = ab[2:6] + 2.0 * expect[2:6]   # re-reads rows 2:4 landed
    ref_out = _run_ref(rsched, {"A": A, "B": B}, C, ctx)
    np.testing.assert_allclose(ref_out, expect, rtol=1e-5, atol=1e-5)
    for mode in ("issue_order", "concurrent"):
        out, _ = _run_port(tsched, {"A": A, "B": B}, C, ctx, mode=mode)
        np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)
    plan = T.compile_executable(tsched)
    h2d_c1 = next(i for i, op in enumerate(tsched.ops)
                  if op.tag == "S(c[1])")
    d2h_c0 = next(i for i, op in enumerate(tsched.ops)
                  if op.tag == "R(c[0])")
    assert d2h_c0 in plan.preds[h2d_c1]


def test_float64_host_operands_computed_in_float32():
    """JAX's 64-bit mode is off in the reference: float64 host data is
    computed in float32 and landed in the float64 output."""
    A, B, C, rpart, rsched = _gemm_case(31, M=192, N=128, K=64)
    A, B, C = (x.astype(np.float64) for x in (A, B, C))
    ctx = {"alpha": 1.0, "beta": -1.0}
    ref_out = _run_ref(rsched, {"A": A, "B": B}, C, ctx)
    out, _ = _run_port(from_reference(rsched), {"A": A, "B": B}, C, ctx)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, A @ B - C, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_unknown_kernel_raises(mode):
    A, B, C, rpart, _ = _gemm_case(20)
    sched = T.build_gemm_schedule(from_reference(rpart))
    i = next(i for i, op in enumerate(sched.ops)
             if isinstance(op.payload, T.BlockRef))
    sched.ops[i] = dataclasses.replace(
        sched.ops[i], payload=T.BlockRef("no_such_kernel", 0))
    with pytest.raises(KeyError, match="no_such_kernel"):
        _run_port(sched, {"A": A, "B": B}, C, {}, mode=mode)


def _factor_matrix(kind, n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    if kind == "cholesky":
        M = M @ M.T / n + np.eye(n)
    return M.astype(np.float32)


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
@pytest.mark.parametrize("kind,n,panel,lookahead", [
    ("cholesky", 256, 64, 1), ("cholesky", 300, 96, 0),
    ("lu", 256, 64, 1), ("lu", 300, 96, 0)])
def test_factor_schedules_match_reference(kind, n, panel, lookahead, mode):
    """The compiled Cholesky and LU schedules (panel handlers, ``dgemm``
    trailing blocks, LU's ``lu_writeback`` finalizer) run on the port's
    executor as on the reference's, on the same matrix: the factored
    matrix within the reference's f32 tolerance of the reference's, LU's
    permutation equal, bytes equal to ``schedule_stats``."""
    A = _factor_matrix(kind, n, n + panel)
    budget = 3 * A.nbytes // 2
    spec = T.factor_pipeline_spec(n, panel, budget, 4, kind=kind,
                                  lookahead=lookahead)
    sched = T.compile_factor_pipeline(spec)
    rsched = R.compile_factor_pipeline(R.factor_pipeline_spec(
        n, panel, budget, 4, kind=kind, lookahead=lookahead))
    ctx = {"alpha": -1.0, "beta": 1.0}
    out = {"A": torch.from_numpy(A.copy())}
    ex = T.ScheduleExecutor(torch_device=CPU, mode=mode)
    st = ex.run(sched, {}, out, ctx)
    ref = {"A": A.copy()}
    rst = R.ScheduleExecutor().run(rsched, {}, ref, ctx)
    stats = T.schedule_stats(sched)
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) == (stats["h2d_bytes"],
                                                      stats["d2h_bytes"])
    got, want = out["A"].numpy(), ref["A"]
    if kind == "cholesky":
        got, want = np.tril(got), np.tril(want)
        tol = 5e-6
    else:
        assert np.array_equal(st.scratch["perm"].numpy(),
                              rst.scratch["perm"])
        tol = 1e-4           # U's entries round apart by more (growth)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_instance_handler_overrides_registry():
    A, B, C, rpart, _ = _gemm_case(22)
    sched = T.build_gemm_schedule(from_reference(rpart))
    seen = []
    out, _ = _run_port(sched, {"A": A, "B": B}, C, {},
                       handlers={"dgemm": lambda st, op, ref:
                                 seen.append(ref.index)})
    assert seen == list(range(from_reference(rpart).nblocks))
    assert np.array_equal(out, C)     # blocks round-trip untouched


def test_plan_cache_identity_hit():
    *_, rpart, _ = _gemm_case(17)
    sched = T.build_gemm_schedule(from_reference(rpart))
    before = T.plan_cache_stats()
    p1 = T.compile_executable(sched)
    p2 = T.compile_executable(sched)
    after = T.plan_cache_stats()
    assert p1 is p2
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] >= before["hits"] + 1


def test_plan_cache_invalidated_on_op_mutation():
    *_, rpart, _ = _gemm_case(18)
    sched = T.build_gemm_schedule(from_reference(rpart))
    p1 = T.compile_executable(sched)
    i = next(idx for idx, op in enumerate(sched.ops)
             if isinstance(op.payload, T.BlockRef))
    sched.ops[i] = dataclasses.replace(sched.ops[i])
    assert T.compile_executable(sched) is not p1


def test_plan_cache_invalidated_on_handler_registration():
    *_, rpart, _ = _gemm_case(19)
    sched = T.build_gemm_schedule(from_reference(rpart))
    p1 = T.compile_executable(sched)
    T.register_op_handler("_test_torch_exec_plan_dummy")(
        lambda st, op, ref: None)
    assert T.compile_executable(sched) is not p1


def test_spans_and_metrics_published_per_run():
    A, B, C, rpart, _ = _gemm_case(23)
    sched = T.build_gemm_schedule(from_reference(rpart))
    stats = T.schedule_stats(sched)
    obs = get_observability()
    obs.reset().enable(metrics=True)
    try:
        _, ex = _run_port(sched, {"A": A, "B": B}, C, {},
                          record_spans=True)
        m = obs.metrics
        got = {name: m.get(name).value(kernel="gemm") for name in (
            "repro_executor_h2d_bytes", "repro_executor_d2h_bytes",
            "repro_executor_flops_total")}
    finally:
        obs.reset().disable()
    assert got == {"repro_executor_h2d_bytes": stats["h2d_bytes"],
                   "repro_executor_d2h_bytes": stats["d2h_bytes"],
                   "repro_executor_flops_total": stats["flops"]}
    assert [s[0] for s in ex.last_spans] == [op.tag for op in sched.ops]
    assert all(0.0 <= s[2] <= s[3] for s in ex.last_spans)


def test_drift_and_run_publication_match_the_reference():
    """The port's obs bundle publishes what the reference's does, for the
    same inputs (fresh instances; the process singletons stay untouched)."""
    from repro.obs import Observability as R_Obs
    from repro_torch.obs import Observability as T_Obs

    *_, rpart, rsched = _gemm_case(25)
    kw = dict(predicted_makespan=2.0, measured_seconds=2.5,
              predicted_h2d_bytes=100, measured_h2d_bytes=100,
              predicted_d2h_bytes=10, measured_d2h_bytes=10)
    snaps = []
    for obs, sched in ((R_Obs(), rsched), (T_Obs(), from_reference(rsched))):
        obs.enable(metrics=True)
        obs.record_drift("gemm", "HBM", "fp0", **kw)
        obs.record_drift("gemm", "HBM", "fp0", **kw)
        obs.record_executor_run(sched, 0.5, 123, 45,
                                spans=[("S(a[0])", 0, 0.0, 0.25)])
        snaps.append(obs.snapshot())
    assert snaps[0] == snaps[1]


# --------------------------------------- twins of tests/test_executor.py
def _problem(rng, M, N, K):
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    return A, B, C


def test_schedules_carry_typed_payloads():
    args = (512, 384, 256, 1_000_000, 4)
    sched = T.build_gemm_schedule(T.plan_gemm_partition(*args))
    ref = R.build_gemm_schedule(R.plan_gemm_partition(*args))
    assert [op_key(o) for o in sched.ops] == [op_key(o) for o in ref.ops]
    for op in sched.ops:
        if op.kind == T.OpKind.COMPUTE:
            assert isinstance(op.payload, T.BlockRef), op.tag
        else:
            assert isinstance(op.payload, T.SliceRef), op.tag
    # the C block round-trips through the same typed slice
    d2h = [o for o in sched.ops if o.kind == T.OpKind.D2H]
    assert all(o.payload.operand == "C" for o in d2h)


@pytest.mark.parametrize("async_wb", [False, True])
def test_executor_async_matches_sync(rng, async_wb):
    """The double-buffered write-back mode is a scheduling property, never
    a numerics property: bit for bit the other mode's result, and the
    reference's within its tolerance."""
    A, B, C = _problem(rng, 320, 256, 128)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    part = T.plan_gemm_partition(320, 256, 128, budget, 4)
    outs = {}
    for wb in (async_wb, not async_wb):
        rt = T.HostOocRuntime(
            T.Device("HBM", 0, budget),
            executor=T.ScheduleExecutor(async_writeback=wb, torch_device=CPU))
        outs[wb] = rt.gemm(A, B, C, 1.25, -0.5, part)
    assert torch.equal(outs[True], outs[False])
    expect = 1.25 * (A.astype(np.float64) @ B) - 0.5 * C
    np.testing.assert_allclose(outs[async_wb].numpy(), expect, rtol=1e-4,
                               atol=1e-4)
    ref = R.HostOocRuntime(executor=R.ScheduleExecutor(
        async_writeback=async_wb)).gemm(
            A, B, C, 1.25, -0.5, R.plan_gemm_partition(320, 256, 128,
                                                       budget, 4))
    np.testing.assert_allclose(outs[async_wb].numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_direct_host_impl_matches_oracle(rng):
    """The hand-rolled baseline dispatches through the port's executor
    and equals the oracle and the reference's baseline."""
    from benchmarks.direct_impls import direct_host_ooc_gemm as r_direct
    from repro_torch.direct_impls import direct_host_ooc_gemm

    A, B, C = _problem(rng, 384, 256, 192)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    out = direct_host_ooc_gemm(A, B, C, 1.5, 0.5, budget, torch_device=CPU)
    expect = 1.5 * (A.astype(np.float64) @ B) + 0.5 * C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    ref = r_direct(A, B, C, 1.5, 0.5, budget)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def _scale_copy_spec(mod, M, N, bm):
    """The reference test's scaled block copy as ``mod``'s PipelineSpec."""
    h = M // bm
    x = mod.StreamedOperand(
        name="X", nblocks=h, block_of=lambda s: s,
        slice_of=lambda b: mod.SliceRef("X", b, rows=(b * bm, bm)),
        bytes_of=lambda b: bm * N * 4,
    )
    y = mod.StreamedOperand(
        name="Y", nblocks=h, block_of=lambda s: s,
        slice_of=lambda b: mod.SliceRef("Y", b, rows=(b * bm, bm)),
        bytes_of=lambda b: bm * N * 4,
        inout=True,
    )
    return mod.PipelineSpec(
        name="scale_copy", nsteps=h, operands=(x, y),
        compute=mod.ComputeStage(kernel="scale_copy", reads=("X",),
                                 flops_of=lambda s: bm * N),
        writeback=mod.WriteBack(mode="each", operand="Y"),
        budget=1 << 20,
    )


def test_new_kernel_via_spec(rng):
    """Reuse claim, falsifiable: a scaled block-copy kernel expressed as a
    PipelineSpec + one registered handler, with no interpreter loop.  The
    handler multiplies into its output buffer, the port's handler contract
    (a rebound tensor, as the reference's handler makes, would be freed
    while a card's write-back stream may still read it)."""
    from repro.core.runtime import register_op_handler as r_register

    M, N, bm = 256, 192, 64
    X = rng.standard_normal((M, N)).astype(np.float32)

    @T.register_op_handler("scale_copy")
    def _scale_copy(st, op, ref):
        torch.mul(st.bufs[op.buffers_read[0]], st.ctx["gamma"],
                  out=st.bufs[op.buffers_written[0]])

    @r_register("scale_copy")
    def _r_scale_copy(st, op, ref):
        key = op.buffers_written[0]
        st.bufs[key] = st.bufs[op.buffers_read[0]] * st.ctx["gamma"]

    sched = T.compile_pipeline(_scale_copy_spec(T, M, N, bm), nstreams=2,
                               nbuf=2)
    rsched = R.compile_pipeline(_scale_copy_spec(R, M, N, bm), nstreams=2,
                                nbuf=2)
    assert [op_key(o) for o in sched.ops] == [op_key(o) for o in rsched.ops]
    T.validate_schedule(sched)
    stats = T.schedule_stats(sched)
    rout = np.zeros((M, N), np.float32)
    R.ScheduleExecutor().run(rsched, operands={"X": X}, outputs={"Y": rout},
                             ctx={"gamma": 3.0})
    for mode in T.ScheduleExecutor.MODES:
        out = torch.zeros(M, N)
        ex = T.ScheduleExecutor(mode=mode, torch_device=CPU)
        ex.run(sched, operands={"X": X}, outputs={"Y": out},
               ctx={"gamma": 3.0})
        np.testing.assert_allclose(out.numpy(), 3.0 * X, rtol=0, atol=0)
        assert np.array_equal(out.numpy(), rout)
        assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
            == (stats["h2d_bytes"], stats["d2h_bytes"])
