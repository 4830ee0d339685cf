"""The port's planning layer against the reference, exactly.

Partitions, schedules (op for op), ``schedule_stats``, compiled executable
plans, simulated makespans and validator verdicts of ``repro_torch.core``
must equal those of ``repro.core`` — these modules are JAX-free copies, so
anything short of equality is a porting fault.  ``from_reference`` must
carry a reference schedule across unchanged.
"""

import dataclasses

import pytest

import repro.core as R
import repro.core.exec_plan as R_xplan
import repro.core.simulator as R_sim
import repro_torch.core as T
from repro_torch.core import exec_plan as T_xplan
from repro_torch.core.convert import from_reference

SHAPES = [(640, 384, 256, 4), (512, 512, 128, 6)]   # M, N, K, budget frac


def _payload(p):
    if p is None:
        return None
    return (type(p).__name__,) + tuple(
        getattr(p, f.name) for f in dataclasses.fields(p))


def _op(op):
    return (op.kind.name, op.tag, op.stream,
            tuple(e.name for e in op.waits),
            op.records.name if op.records is not None else None,
            tuple(op.buffers_read), tuple(op.buffers_written),
            op.bytes, op.flops, _payload(op.payload))


def _models(mod, v5e):
    return [mod.gpu_like(), mod.phi_like(), mod.phi_like(nstreams=2), v5e]


def _assert_same_schedule(ref, port):
    assert [_op(o) for o in ref.ops] == [_op(o) for o in port.ops]
    assert [[_op(o) for o in s.ops] for s in ref.streams] \
        == [[_op(o) for o in s.ops] for s in port.streams]
    assert ref.reuse == port.reuse and ref.meta == port.meta
    assert R.schedule_stats(ref) == T.schedule_stats(port)
    assert from_reference(ref) == port
    rp, tp = R.compile_executable(ref), T.compile_executable(port)
    for f in ("n_ops", "kinds", "engines", "engine_of", "queues", "preds",
              "kernels"):
        assert getattr(rp, f) == getattr(tp, f), f
    v5e = R_sim.tpu_v5e_vmem()
    for rm, tm in zip(_models(R_sim, v5e),
                      _models(T, from_reference(v5e))):
        rs, ts = R.simulate(ref, rm), T.simulate(port, tm)
        assert rs.makespan == ts.makespan
        assert rs.busy == ts.busy and rs.op_spans == ts.op_spans
        assert (rs.h2d_bytes, rs.d2h_bytes, rs.flops) \
            == (ts.h2d_bytes, ts.d2h_bytes, ts.flops)


def _parts(M, N, K, frac):
    budget = (M * K + K * N + M * N) * 4 // frac
    rp = R.plan_gemm_partition(M, N, K, budget, 4)
    tp = T.plan_gemm_partition(M, N, K, budget, 4)
    assert from_reference(rp) == tp
    return rp, tp


@pytest.mark.parametrize("evict", ["lru", "belady"])
@pytest.mark.parametrize("traversal", list(T.TRAVERSALS))
@pytest.mark.parametrize("nbuf", [1, 2, 3])
@pytest.mark.parametrize("nstreams", [1, 2])
def test_gemm_syrk_schedules_identical(nstreams, nbuf, traversal, evict):
    kw = dict(nstreams=nstreams, nbuf=nbuf, traversal=traversal,
              evict=evict)
    for M, N, K, frac in SHAPES:
        rp, tp = _parts(M, N, K, frac)
        _assert_same_schedule(R.build_gemm_schedule(rp, **kw),
                              T.build_gemm_schedule(tp, **kw))
        rs, ts = _parts(M, M, K, frac)
        _assert_same_schedule(R.build_syrk_schedule(rs, **kw),
                              T.build_syrk_schedule(ts, **kw))


@pytest.mark.parametrize("M,N,K,frac", SHAPES)
def test_vendor_schedule_identical(M, N, K, frac):
    rp, tp = _parts(M, N, K, frac)
    _assert_same_schedule(R.build_vendor_schedule(rp, tile=128),
                          T.build_vendor_schedule(tp, tile=128))


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factor_schedule_identical(kind, lookahead):
    n = 384
    rspec = R.factor_pipeline_spec(n, 128, 3 * n * n * 8, 8, kind=kind,
                                   lookahead=lookahead)
    tspec = T.factor_pipeline_spec(n, 128, 3 * n * n * 8, 8, kind=kind,
                                   lookahead=lookahead)
    _assert_same_schedule(R.compile_factor_pipeline(rspec, nstreams=2,
                                                    nbuf=2),
                          T.compile_factor_pipeline(tspec, nstreams=2,
                                                    nbuf=2))


@pytest.mark.parametrize("nstreams,nbuf", [(1, 1), (2, 2)])
def test_attention_schedule_identical(nstreams, nbuf):
    args = (8192, 8, 128, 4 * 2**20, 2)
    rpart = R.plan_attention_partition(*args)
    tpart = T.plan_attention_partition(*args)
    assert from_reference(rpart) == tpart
    _assert_same_schedule(
        R.build_attention_schedule(rpart, 8, 128, 32, nstreams=nstreams,
                                   nbuf=nbuf),
        T.build_attention_schedule(tpart, 8, 128, 32, nstreams=nstreams,
                                   nbuf=nbuf))


@pytest.mark.parametrize("M,N,K,budget,nbuf,nstreams", [
    (1024, 1024, 512, 2_000_000, None, None),
    (24576, 24576, 24576, 2 * 2**30, None, None),
    (24576, 24576, 24576, 2 * 2**30, 2, 2),
    (300, 200, 150, 100_000, 3, None),
    (4096, 128, 4096, 5_000_000, None, 3),
    (128, 128, 64, 1 << 30, None, None),
    (8192, 8192, 8192, 1_000_000, None, None),   # infeasible: both raise
])
def test_partition_identical(M, N, K, budget, nbuf, nstreams):
    args = (M, N, K, budget, 4)
    kw = dict(nbuf=nbuf, nstreams=nstreams)
    try:
        rp = R.plan_gemm_partition(*args, **kw)
    except ValueError as exc:
        with pytest.raises(ValueError, match="cannot fit budget"):
            T.plan_gemm_partition(*args, **kw)
        assert "cannot fit budget" in str(exc)
        return
    tp = T.plan_gemm_partition(*args, **kw)
    assert dataclasses.astuple(rp) == dataclasses.astuple(tp)
    for depth in (None, 1, 2, 3):
        assert rp.working_set_bytes(depth) == tp.working_set_bytes(depth)
    assert list(rp.blocks()) == list(tp.blocks())


@pytest.mark.parametrize("traversal", list(T.TRAVERSALS))
def test_traversal_order_identical(traversal):
    for h, w in ((1, 1), (4, 3), (5, 7)):
        for band in (None, 2, 3):
            assert R.traversal_order(h, w, traversal, band) \
                == T.traversal_order(h, w, traversal, band)


def _broken(mod, case):
    dev = mod.Device("HBM", 0, 1 << 20)
    sched = mod.Schedule(dev, mod.StreamFactory.create(dev, 2))
    if case == "missing_wait":
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(a0)", stream=0,
                           records=mod.Event("r0"),
                           buffers_written=(("A", 0),), bytes=64))
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="GEMM", stream=1,
                           buffers_read=(("A", 0),), flops=10))
    else:
        e1, e2 = mod.Event("e1"), mod.Event("e2")
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="a", stream=0,
                           waits=(e2,), records=e1))
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag="b", stream=1,
                           waits=(e1,), records=e2))
    return sched


@pytest.mark.parametrize("case", ["missing_wait", "deadlock"])
def test_validator_rejects_what_the_reference_rejects(case):
    ref = _broken(R, case)
    with pytest.raises(R.ScheduleError) as rexc:
        R.validate_schedule(ref)
    port = _broken(T, case)
    assert from_reference(ref) == port
    with pytest.raises(T.ScheduleError) as texc:
        T.validate_schedule(port)
    assert str(rexc.value) == str(texc.value)


def test_hardware_models_carried_across():
    for name in ("gpu_like", "phi_like"):
        assert from_reference(getattr(R_sim, name)()) == getattr(T, name)()
    assert not hasattr(T, "tpu_v5e_vmem")
    assert (R_xplan.ENGINE_H2D, R_xplan.ENGINE_D2H) \
        == (T_xplan.ENGINE_H2D, T_xplan.ENGINE_D2H)
