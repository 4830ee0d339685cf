"""Property-based conformance on the port: the twins of
``tests/test_properties.py``, through the same hypothesis shim and
settings.

Each draw builds the schedule in both packages: the port's must be the
reference's op for op, pass the validator, and keep issue order a linear
extension of the dependency order; its simulation must equal the
reference's span for span and honour every dependency.  Execution runs on
the port's executor on the CPU (both modes synchronous in issue order
there; the card's concurrent mode is held by ``tests/test_torch_card.py``)
against the reference's fp32 tolerance.
"""

import numpy as np
import pytest
import torch
from tests._hypothesis_shim import given, settings, st

import repro.core as R
import repro_torch.core as T
from repro_torch.core.convert import from_reference
from _torch_helpers import one_torch_thread, op_key  # noqa: F401

dims = st.sampled_from([128, 256, 384, 512])
CPU = "cpu"


def _dependency_edges(sched):
    """(pred, succ) pairs of the dependency partial order both engines
    must honor: per-stream program order plus wait -> recorder edges."""
    recorder = {}
    for idx, op in enumerate(sched.ops):
        if op.records is not None:
            recorder[op.records.name] = idx
    edges = []
    last_in_stream = {}
    for idx, op in enumerate(sched.ops):
        if op.stream in last_in_stream:
            edges.append((last_in_stream[op.stream], idx))
        last_in_stream[op.stream] = idx
        for ev in op.waits:
            edges.append((recorder[ev.name], idx))
    return edges


def _same(ref, port):
    assert [op_key(o) for o in port.ops] == [op_key(o) for o in ref.ops]
    return port


def _assert_simulator_honors_deps(sched, rsched):
    res = T.simulate(sched, T.gpu_like())
    rres = R.simulate(rsched, R.gpu_like())
    assert res.op_spans == rres.op_spans and res.makespan == rres.makespan
    # spans are appended in placement order; map each op to its span by
    # counting per-stream (a stream's ops keep their program order)
    per_stream = {}
    span_of = {}
    for tag, stream, t0, t1 in res.op_spans:
        pos = per_stream.get(stream, 0)
        per_stream[stream] = pos + 1
        span_of[(stream, pos)] = (t0, t1)
    pos_of = {}
    seen = {}
    for idx, op in enumerate(sched.ops):
        pos_of[idx] = (op.stream, seen.get(op.stream, 0))
        seen[op.stream] = seen.get(op.stream, 0) + 1
    for pred, succ in _dependency_edges(sched):
        t_pred_end = span_of[pos_of[pred]][1]
        t_succ_start = span_of[pos_of[succ]][0]
        assert t_succ_start >= t_pred_end - 1e-12, (
            f"simulator started {sched.ops[succ].tag} at {t_succ_start} "
            f"before its dependency {sched.ops[pred].tag} ended at "
            f"{t_pred_end}")
    return res


def _assert_executor_is_linear_extension(sched):
    """The executor completes ops in issue order; that order must extend
    the dependency partial order."""
    for pred, succ in _dependency_edges(sched):
        assert pred < succ, (
            f"issue order is not a linear extension: "
            f"{sched.ops[succ].tag} (issue {succ}) depends on "
            f"{sched.ops[pred].tag} (issue {pred})")


def _parts(M, N, K, budget):
    rp = R.plan_gemm_partition(M, N, K, budget, 4)
    tp = T.plan_gemm_partition(M, N, K, budget, 4)
    assert from_reference(rp) == tp
    return rp, tp


# ------------------------------------------------------------ validate
@given(M=dims, N=dims, K=dims,
       nstreams=st.sampled_from([1, 2, 3]),
       nbuf=st.sampled_from([1, 2, 3]),
       frac=st.sampled_from([2, 4, 8]))
@settings(max_examples=40, deadline=None)
def test_random_gemm_specs_validate(M, N, K, nstreams, nbuf, frac):
    full = (M * K + K * N + M * N) * 4
    rp, tp = _parts(M, N, K, max(full // frac, 700_000))
    for build in ("build_gemm_schedule", "build_syrk_schedule"):
        sched = _same(getattr(R, build)(rp, nstreams=nstreams, nbuf=nbuf),
                      getattr(T, build)(tp, nstreams=nstreams, nbuf=nbuf))
        T.validate_schedule(sched)
        _assert_executor_is_linear_extension(sched)
    T.validate_schedule(_same(R.build_vendor_schedule(rp),
                              T.build_vendor_schedule(tp)))


@given(S=st.sampled_from([512, 1024, 2048]),
       nstreams=st.sampled_from([1, 2]),
       nbuf=st.sampled_from([2, 3]),
       frac=st.sampled_from([2, 6]))
@settings(max_examples=20, deadline=None)
def test_random_attention_specs_validate(S, nstreams, nbuf, frac):
    kv_heads, head_dim, q_heads = 4, 64, 16
    budget = max(2 * S * kv_heads * head_dim * 2 // frac, 300_000)
    args = (S, kv_heads, head_dim, budget, 2)
    rp, tp = R.plan_attention_partition(*args), \
        T.plan_attention_partition(*args)
    assert from_reference(rp) == tp
    kw = dict(nstreams=nstreams, nbuf=nbuf)
    sched = _same(
        R.build_attention_schedule(rp, kv_heads, head_dim, q_heads, **kw),
        T.build_attention_schedule(tp, kv_heads, head_dim, q_heads, **kw))
    T.validate_schedule(sched)
    _assert_executor_is_linear_extension(sched)


@given(n=st.sampled_from([256, 320, 512, 700]),
       panel=st.sampled_from([64, 96, 128, 512]),
       kind=st.sampled_from(["cholesky", "lu"]),
       lookahead=st.sampled_from([0, 1, 2]),
       nstreams=st.sampled_from([1, 2]),
       nbuf=st.sampled_from([1, 2, 3]))
@settings(max_examples=40, deadline=None)
def test_random_factor_specs_validate(n, panel, kind, lookahead, nstreams,
                                      nbuf):
    args = (n, panel, 64 * n * n * 4, 4)
    kw = dict(kind=kind, lookahead=lookahead, nbuf=nbuf, bm=64, bn=128)
    sched = _same(
        R.compile_factor_pipeline(R.factor_pipeline_spec(*args, **kw),
                                  nstreams=nstreams, nbuf=nbuf),
        T.compile_factor_pipeline(T.factor_pipeline_spec(*args, **kw),
                                  nstreams=nstreams, nbuf=nbuf))
    T.validate_schedule(sched)
    _assert_executor_is_linear_extension(sched)
    rsched = R.compile_factor_pipeline(R.factor_pipeline_spec(*args, **kw),
                                       nstreams=nstreams, nbuf=nbuf)
    _assert_simulator_honors_deps(sched, rsched)


# ------------------------------------- simulate-vs-execute conformance
@given(M=dims, N=dims, K=st.sampled_from([128, 256]),
       nstreams=st.sampled_from([1, 2]),
       nbuf=st.sampled_from([1, 2, 3]))
@settings(max_examples=10, deadline=None)
def test_executor_completion_extends_simulator_order(M, N, K, nstreams,
                                                     nbuf):
    """Execute a GEMM schedule with span recording on the port: ops
    complete in issue order, a linear extension of the dependency order
    the simulator schedules by, and the spans cover every op."""
    rng = np.random.default_rng(M + N + K)
    full = (M * K + K * N + M * N) * 4
    rp, tp = _parts(M, N, K, max(full // 4, 700_000))
    rsched = R.build_gemm_schedule(rp, nstreams=nstreams, nbuf=nbuf)
    sched = _same(rsched, T.build_gemm_schedule(tp, nstreams=nstreams,
                                                nbuf=nbuf))
    T.validate_schedule(sched)
    _assert_executor_is_linear_extension(sched)
    _assert_simulator_honors_deps(sched, rsched)

    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = torch.zeros(M, N)
    ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
    ex.run(sched, operands={"A": A, "B": B}, outputs={"C": C},
           ctx={"alpha": 1.0, "beta": 0.0})
    assert len(ex.last_spans) == len(sched.ops)
    assert ex.last_completion_order == list(range(len(sched.ops)))
    # completion timestamps are monotone in issue order (in-order engine),
    # so span order IS completion order; it matches issue order op-for-op
    for (tag, stream, t0, t1), op in zip(ex.last_spans, sched.ops):
        assert tag == op.tag and stream == op.stream
    ends = [t1 for _, _, _, t1 in ex.last_spans]
    assert all(b >= a - 1e-12 for a, b in zip(ends, ends[1:]))
    np.testing.assert_allclose(C.numpy(), A.astype(np.float64) @ B,
                               rtol=1e-4, atol=1e-4)


@given(M=dims, N=dims, K=st.sampled_from([128, 256]),
       nstreams=st.sampled_from([1, 2, 3]),
       nbuf=st.sampled_from([1, 2, 3]))
@settings(max_examples=10, deadline=None)
def test_concurrent_completion_is_linear_extension(M, N, K, nstreams, nbuf):
    """mode="concurrent": the completion order is a linear extension of
    the dependency partial order, and the result bit for bit the serial
    one's (on the CPU both run in issue order)."""
    rng = np.random.default_rng(M * 3 + N * 5 + K)
    full = (M * K + K * N + M * N) * 4
    rp, tp = _parts(M, N, K, max(full // 4, 700_000))
    sched = _same(R.build_gemm_schedule(rp, nstreams=nstreams, nbuf=nbuf),
                  T.build_gemm_schedule(tp, nstreams=nstreams, nbuf=nbuf))
    T.validate_schedule(sched)

    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C_ser = torch.zeros(M, N)
    T.ScheduleExecutor(torch_device=CPU).run(
        sched, {"A": A, "B": B}, {"C": C_ser}, {"alpha": 1.0, "beta": 0.0})
    C_conc = torch.zeros(M, N)
    ex = T.ScheduleExecutor(mode="concurrent", torch_device=CPU)
    ex.run(sched, {"A": A, "B": B}, {"C": C_conc},
           {"alpha": 1.0, "beta": 0.0})
    assert torch.equal(C_ser, C_conc)
    order = ex.last_completion_order
    assert sorted(order) == list(range(len(sched.ops)))
    pos = {op_idx: k for k, op_idx in enumerate(order)}
    for pred, succ in _dependency_edges(sched):
        assert pos[pred] < pos[succ], (
            f"concurrent completion violated dependency "
            f"{sched.ops[pred].tag} -> {sched.ops[succ].tag}")


def test_factor_executor_conformance():
    """The multi-kernel factor schedule (panel ops + trailing stream +
    lookahead reordering) completes as a linear extension of its
    dependency order on the port, with spans for every op."""
    rng = np.random.default_rng(9)
    n = 320
    X = rng.standard_normal((n, n)).astype(np.float32)
    A = (X @ X.T + n * np.eye(n)).astype(np.float32)
    args = (n, 96, 64 * n * n * 4, 4)
    kw = dict(kind="cholesky", lookahead=1, bm=64, bn=128)
    sched = _same(
        R.compile_factor_pipeline(R.factor_pipeline_spec(*args, **kw),
                                  nstreams=2, nbuf=2),
        T.compile_factor_pipeline(T.factor_pipeline_spec(*args, **kw),
                                  nstreams=2, nbuf=2))
    T.validate_schedule(sched)
    _assert_executor_is_linear_extension(sched)
    out = torch.from_numpy(A.copy())
    ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
    ex.run(sched, operands={}, outputs={"A": out},
           ctx={"alpha": -1.0, "beta": 1.0, "panel": 96, "n": n})
    assert len(ex.last_spans) == len(sched.ops)
    expect = np.linalg.cholesky(A.astype(np.float64))
    np.testing.assert_allclose(np.tril(out.numpy()), expect, rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------- lookahead properties
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_lookahead_never_slower_than_sequential(kind):
    """Same block geometry, same transfers: the lookahead event graph is a
    relaxation of the sequential one, so its simulated makespan (the
    reference's, exactly) cannot regress."""
    makespans = {}
    for la in (0, 1):
        args = (4096, 512, 512 * 2**20, 8)
        kw = dict(kind=kind, lookahead=la, bm=512, bn=1024)
        rsched = R.compile_factor_pipeline(R.factor_pipeline_spec(*args,
                                                                  **kw))
        sched = _same(rsched, T.compile_factor_pipeline(
            T.factor_pipeline_spec(*args, **kw)))
        res = T.simulate(sched, T.gpu_like())
        assert res.makespan == R.simulate(rsched, R.gpu_like()).makespan
        makespans[la] = res.makespan
    assert makespans[1] <= makespans[0] * 1.02, makespans
