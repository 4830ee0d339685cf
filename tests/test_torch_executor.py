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
                            overlap_schedule)

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


@pytest.mark.parametrize("kind,item", [("cholesky", "item 5"),
                                       ("attention", "item 4")])
def test_handlers_outside_the_slice_raise(kind, item):
    if kind == "cholesky":
        spec = T.factor_pipeline_spec(256, 128, 3 * 256 * 256 * 4, 4)
        sched = T.compile_factor_pipeline(spec)
        operands, outputs = {}, {"A": np.eye(256, dtype=np.float32)}
    else:
        part = T.plan_attention_partition(512, 2, 64, 2**19, 4)
        sched = T.build_attention_schedule(part, 2, 64, 8)
        kv = np.zeros((512, 2, 64), np.float32)
        operands, outputs = {"K": kv, "V": kv}, {"out": np.zeros((8, 64))}
    with pytest.raises(NotImplementedError, match=item):
        T.ScheduleExecutor(torch_device=CPU).run(sched, operands, outputs)


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


def test_faults_are_not_ported():
    *_, rpart, _ = _gemm_case(24)
    sched = T.build_gemm_schedule(from_reference(rpart))
    with pytest.raises(NotImplementedError, match="item 6"):
        T.ScheduleExecutor(torch_device=CPU).run(sched, {}, {}, faults=[1])


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
