"""Fault injection and recovery in the port against the reference (CPU).

Twins of ``test_fault.py`` for the pieces that are ported: the plan,
injector, policy and redo-set modules, the executor's faulted path
(transfer retries with backoff, block-granular replay of corrupted
computes) and the oom degrade ladders of ``ooc_gemm``, ``ooc_cholesky``
and ``ooc_lu``.  The same numpy inputs go through ``repro`` and
``repro_torch`` (``torch_device="cpu"``, one BLAS thread, so the port's
plain path sums each element in one order):

  * a recovered port run equals the port's own clean run bit for bit, and
    the reference's result at the reference's tolerance;
  * ``last_fault_stats`` equals the reference's, key for key, under the
    same plan;
  * ``redo_set`` and the degrade steps equal the reference's.

The port's buffers are updated in place, so a replay's inputs are
copy-on-write clones (``runtime._ReplayLog``);
``test_replay_rebinds_inputs_a_landing_overwrote`` drives the case where
they matter.  The hybrid device-lost twins hold a rebalanced run against
the port's clean hybrid run, bit for bit (the reference's SYRK twin fails
on its own side: its hybrid SYRK is not bitwise).
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.ooc_factor as R_factor
import repro.fault as RF
import repro.hybrid as RH
import repro_torch.core as T
import repro_torch.core.runtime as T_runtime
import repro_torch.fault as TF
import repro_torch.hybrid as TH
from repro.core.api import hclFaultPolicy as R_hclFaultPolicy
from repro.kernels.ref import gemm_ref
from repro.obs import get_observability as R_obs
from repro_torch.core.api import hclFaultPolicy
from repro_torch.obs import get_observability

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
RTOL = ATOL = 1e-4          # the port's f32 block GEMM against the reference


@pytest.fixture(autouse=True)
def _clean_obs():
    for obs in (get_observability(), R_obs()):
        obs.reset().disable()
    yield
    for obs in (get_observability(), R_obs()):
        obs.reset().disable()


def _gemm_case(m=128, n=48, k=32, budget=60_000, seed=0, nstreams=2,
               nbuf=2):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C = rng.standard_normal((m, n))
    part = T.plan_gemm_partition(m, n, k, budget)
    sched = T.build_gemm_schedule(part, nstreams=nstreams, nbuf=nbuf)
    rpart = R.plan_gemm_partition(m, n, k, budget)
    rsched = R.build_gemm_schedule(rpart, nstreams=nstreams, nbuf=nbuf)
    return A, B, C, part, sched, rpart, rsched


def _rt(executor=None):
    return T.HostOocRuntime(T.Device("HBM", 0, 1 << 30), executor=executor,
                            torch_device=None if executor else CPU)


def _quiet(**kw):
    return dict(sleep=lambda s: None, **kw)


def _fake_clock():
    slept = []
    return slept, lambda s: slept.append(s)


def _same_plan(plan, mod):
    """``plan`` rebuilt from the other package's classes."""
    return mod.FaultPlan(specs=tuple(
        mod.FaultSpec(op=s.op, cls=s.cls, times=s.times, stream=s.stream,
                      device=s.device) for s in plan.specs), seed=plan.seed)


def _spec_keys(plan):
    return [(s.op, s.cls, s.times, s.stream, s.device) for s in plan.specs]


def _first(sched, kind):
    return next(i for i, op in enumerate(sched.ops) if op.kind.name == kind)


def _both_gemm(case, plan, policy_kw=None):
    """The port and the reference under the same plan: (port out, port
    stats, reference out, reference stats)."""
    A, B, C, part, sched, rpart, rsched = case
    kw = policy_kw or {}
    rt = _rt()
    out = rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched, faults=plan,
                  policy=TF.FaultPolicy(**_quiet(**kw)))
    rrt = R.HostOocRuntime()
    rout = rrt.gemm(A, B, C, 1.0, 0.5, rpart, schedule=rsched,
                    faults=_same_plan(plan, RF),
                    policy=RF.FaultPolicy(**_quiet(**kw)))
    return (out, rt.executor.last_fault_stats, rout,
            rrt.executor.last_fault_stats)


# ------------------------------------------------------------- plan basics
@pytest.mark.parametrize("mod", [TF, RF], ids=["port", "reference"])
def test_fault_spec_validation(mod):
    with pytest.raises(ValueError, match="unknown fault class"):
        mod.FaultSpec(op=0, cls="cosmic_ray")
    with pytest.raises(ValueError, match="op index"):
        mod.FaultSpec(op=-1, cls="h2d_error")
    with pytest.raises(ValueError, match="times"):
        mod.FaultSpec(op=0, cls="h2d_error", times=0)
    with pytest.raises(ValueError, match="rate"):
        mod.FaultPlan.random(0, None, 1.5)


@pytest.mark.parametrize("seed,rate", [(7, 0.5), (0, 0.1), (3, 1.0)])
def test_random_plan_is_deterministic_and_matches_reference(seed, rate):
    *_, sched, _, rsched = _gemm_case()
    p1 = TF.FaultPlan.random(seed, sched, rate)
    assert p1.specs == TF.FaultPlan.random(seed, sched, rate).specs
    assert len(p1) > 0 and p1.seed == seed
    # one rng draw per op: the port's schedule equals the reference's op
    # for op, so the plans are equal spec for spec
    assert _spec_keys(p1) == _spec_keys(RF.FaultPlan.random(seed, rsched,
                                                            rate))
    h2d_only = TF.FaultPlan.random(seed, sched, rate, classes=("h2d_error",))
    assert set(h2d_only.specs) == {
        s for s in p1.specs if s.cls == "h2d_error"}
    for s in p1.specs:
        op = sched.ops[s.op]
        assert s.stream == op.stream
        assert (op.kind == T.OpKind.H2D) == (s.cls == "h2d_error")
    capped = TF.FaultPlan.random(seed, sched, rate, max_faults=2)
    assert capped.specs == p1.specs[:2]


def test_injector_consumes_per_attempt_and_checks_stream_pin():
    *_, sched, _, _ = _gemm_case()
    h2d = _first(sched, "H2D")
    plan = TF.FaultPlan(specs=(TF.FaultSpec(op=h2d, cls="h2d_error",
                                            times=2),))
    inj = plan.injector()
    op = sched.ops[h2d]
    assert inj.check(h2d, op) == "h2d_error"
    assert not inj.exhausted()
    assert inj.check(h2d, op) == "h2d_error"
    assert inj.check(h2d, op) is None
    assert inj.exhausted()
    assert inj.injected == [(h2d, "h2d_error"), (h2d, "h2d_error")]

    bad = TF.FaultPlan(specs=(TF.FaultSpec(op=h2d, cls="h2d_error",
                                           stream=op.stream + 1),)).injector()
    with pytest.raises(ValueError, match="pins op"):
        bad.check(h2d, op)


def test_for_device_shards_pinned_specs():
    plan = TF.FaultPlan(specs=(
        TF.FaultSpec(op=0, cls="h2d_error", device="gpu0"),
        TF.FaultSpec(op=1, cls="h2d_error", device="phi0"),
        TF.FaultSpec(op=2, cls="h2d_error")))
    assert [s.op for s in plan.for_device("gpu0").specs] == [0, 2]
    assert not TF.FaultPlan() and len(TF.FaultPlan()) == 0


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("nbuf,lookahead,budget,tuned,halvings", [
    (2, 0, 60_000, False, 2), (4, 1, 1 << 20, False, 2),
    (1, 1, 3, False, 3), (2, 1, 1 << 20, True, 2), (1, 0, 1, False, 2),
])
def test_degrade_ladder_and_backoff_match_reference(nbuf, lookahead, budget,
                                                    tuned, halvings):
    kw = dict(max_budget_halvings=halvings, backoff_base=0.5,
              backoff_factor=3.0, max_retries=4)
    pol, rpol = TF.FaultPolicy(**kw), RF.FaultPolicy(**kw)
    got = pol.degrade_ladder(nbuf=nbuf, lookahead=lookahead,
                             budget_bytes=budget, tuned=tuned)
    want = rpol.degrade_ladder(nbuf=nbuf, lookahead=lookahead,
                               budget_bytes=budget, tuned=tuned)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert pol.backoff_schedule() == rpol.backoff_schedule()


def test_policy_fault_model_is_the_ports_simulator_model():
    from repro_torch.core.simulator import FaultModel

    fm = TF.FaultPolicy(backoff_base=0.02).fault_model(0.05)
    assert isinstance(fm, FaultModel)
    assert (fm.rate, fm.mean_backoff, fm.redo_factor) == (0.05, 0.02, 1.0)


# --------------------------------------------------- retry / backoff oracle
def test_backoff_schedule_pinned_against_fake_clock():
    slept, sleep = _fake_clock()
    pol = TF.FaultPolicy(backoff_base=0.5, backoff_factor=2.0, max_retries=3,
                         sleep=sleep)
    assert pol.backoff_schedule() == [0.5, 1.0, 2.0]

    case = _gemm_case()
    A, B, C, part, sched, rpart, rsched = case
    h2d = _first(sched, "H2D")
    rt = _rt()
    clean = rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched)
    nominal_h2d = rt.executor.last_h2d_bytes

    plan = TF.FaultPlan(specs=(TF.FaultSpec(op=h2d, cls="h2d_error",
                                            times=2),))
    out = rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched, faults=plan,
                  policy=pol)
    assert torch.equal(out, clean)
    assert slept == [0.5, 1.0]
    st = rt.executor.last_fault_stats
    assert st["injected"] == 2 and st["retries"] == 2
    assert st["recovered_retry"] == 1
    assert st["backoff_seconds"] == pytest.approx(1.5)
    assert rt.executor.last_h2d_bytes == nominal_h2d
    assert st["replayed_h2d_bytes"] == 2 * sched.ops[h2d].bytes
    # the reference under the same plan: the same record, the same result
    rrt = R.HostOocRuntime()
    rout = rrt.gemm(A, B, C, 1.0, 0.5, rpart, schedule=rsched,
                    faults=_same_plan(plan, RF),
                    policy=RF.FaultPolicy(backoff_base=0.5, max_retries=3,
                                          sleep=lambda s: None))
    assert rrt.executor.last_fault_stats == st
    np.testing.assert_allclose(out.numpy(), rout, rtol=RTOL, atol=ATOL)


def test_transfer_retries_exhaust_and_raise():
    case = _gemm_case()
    A, B, C, part, sched, rpart, rsched = case
    h2d = _first(sched, "H2D")
    plan = TF.FaultPlan(specs=(TF.FaultSpec(op=h2d, cls="h2d_error",
                                            times=3),))
    rt = _rt()
    with pytest.raises(TF.TransferError, match="after 2 retries"):
        rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched, faults=plan,
                policy=TF.FaultPolicy(**_quiet(max_retries=2)))
    rrt = R.HostOocRuntime()
    with pytest.raises(RF.TransferError, match="after 2 retries"):
        rrt.gemm(A, B, C, 1.0, 0.5, rpart, schedule=rsched,
                 faults=_same_plan(plan, RF),
                 policy=RF.FaultPolicy(**_quiet(max_retries=2)))
    # a terminal raise still publishes the injection record
    assert rt.executor.last_fault_stats["injected"] == 3
    assert rt.executor.last_fault_stats == rrt.executor.last_fault_stats


def test_h2d_fault_on_compute_op_is_authoring_error():
    A, B, C, part, sched, *_ = _gemm_case()
    ci = _first(sched, "COMPUTE")
    with pytest.raises(ValueError, match="h2d_error into compute"):
        _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched,
                   faults=TF.FaultPlan(specs=(
                       TF.FaultSpec(op=ci, cls="h2d_error"),)),
                   policy=TF.FaultPolicy(**_quiet()))


# ------------------------------------------------------ compute replay oracle
@pytest.mark.parametrize("nstreams,nbuf", [(2, 2), (1, 1), (2, 3)])
def test_compute_replay_every_op_bitwise_and_matches_static_redo_set(
        nstreams, nbuf):
    case = _gemm_case(nstreams=nstreams, nbuf=nbuf)
    A, B, C, part, sched, *_ = case
    clean = _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched)
    for ci, op in enumerate(sched.ops):
        if op.kind != T.OpKind.COMPUTE:
            continue
        plan = TF.FaultPlan(specs=(TF.FaultSpec(op=ci, cls="compute_nan"),))
        out, st, rout, rst = _both_gemm(case, plan)
        assert torch.equal(out, clean), f"replay at op {ci} diverged"
        assert st["recovered_replay"] == 1
        assert st["replayed_ops"] == len(TF.redo_set(sched, ci))
        assert st == rst
        np.testing.assert_allclose(out.numpy(), rout, rtol=RTOL, atol=ATOL)


def test_unrecoverable_compute_fault_raises_compute_fault():
    A, B, C, part, sched, *_ = _gemm_case()
    ci = _first(sched, "COMPUTE")
    plan = TF.FaultPlan(specs=(TF.FaultSpec(op=ci, cls="compute_nan",
                                            times=4),))
    rt = _rt()
    with pytest.raises(TF.ComputeFault, match="retries exhausted"):
        rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched, faults=plan,
                policy=TF.FaultPolicy(**_quiet(max_retries=2)))
    assert rt.executor.last_fault_stats["injected"] == 3


def test_compute_fault_on_a_finalizer_is_not_replayable():
    """A compute fault addressed to an op outside ``REPLAYABLE_KERNELS``
    (here a transfer) raises instead of replaying."""
    A, B, C, part, sched, *_ = _gemm_case()
    d2h = _first(sched, "D2H")
    with pytest.raises(TF.ComputeFault, match="not replayable"):
        _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched,
                   faults=TF.FaultPlan(specs=(
                       TF.FaultSpec(op=d2h, cls="compute_nan"),)),
                   policy=TF.FaultPolicy(**_quiet()))


@pytest.mark.parametrize("kind", ["gemm", "cholesky", "lu"])
def test_redo_set_properties_match_reference(kind):
    if kind == "gemm":
        *_, sched, _, rsched = _gemm_case()
    else:
        spec = T.factor_pipeline_spec(128, 32, 4 * 128 * 128 * 8, 8,
                                      kind=kind)
        sched = T.compile_factor_pipeline(spec)
        rsched = R.compile_factor_pipeline(R.factor_pipeline_spec(
            128, 32, 4 * 128 * 128 * 8, 8, kind=kind))
    computes = [i for i, op in enumerate(sched.ops)
                if op.kind == T.OpKind.COMPUTE
                and len(op.buffers_written) == 1]
    assert computes
    for ci in computes:
        rs = TF.redo_set(sched, ci)
        assert rs == RF.redo_set(rsched, ci)
        assert rs[-1] == ci and rs == sorted(rs)
        key = sched.ops[ci].buffers_written[0]
        for j in rs[:-1]:
            assert key in sched.ops[j].buffers_written
    h2d = _first(sched, "H2D")
    with pytest.raises(ValueError, match="not a single-writer compute"):
        TF.redo_set(sched, h2d)
    assert TF.mean_redo_len(sched) == RF.mean_redo_len(rsched) >= 1.0
    hw, rhw = T.gpu_like(), R.gpu_like()
    assert TF.redo_cost(sched, hw, computes[0]) \
        == RF.redo_cost(rsched, rhw, computes[0]) > 0.0


def test_replay_rebinds_inputs_a_landing_overwrote():
    """A chain whose inputs are overwritten in place before the replay
    needs them: C0 accumulates two K halves through the same A0/B0 parity
    buffers, and a compute fault on the second update replays the first on
    A0/B0's earlier contents.  Without the copy-on-write clones the replay
    would read the second half twice."""
    rng = np.random.default_rng(41)
    A = rng.standard_normal((8, 16)).astype(np.float32)
    B = rng.standard_normal((16, 6)).astype(np.float32)
    C = rng.standard_normal((8, 6)).astype(np.float32)

    def sched_of(mod):
        dev = mod.Device("HBM", 0, 1 << 20)
        sched = mod.Schedule(dev, mod.StreamFactory.create(dev, 1))
        for h in range(2):
            sched.issue(mod.Op(kind=mod.OpKind.H2D, tag=f"S(a[{h}])",
                               stream=0, buffers_written=(("A", 0),),
                               bytes=8 * 8 * 4, payload=mod.SliceRef(
                                   "A", h, cols=(8 * h, 8))))
            sched.issue(mod.Op(kind=mod.OpKind.H2D, tag=f"S(b[{h}])",
                               stream=0, buffers_written=(("B", 0),),
                               bytes=8 * 6 * 4, payload=mod.SliceRef(
                                   "B", h, rows=(8 * h, 8))))
            if h == 0:
                sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(c)",
                                   stream=0, buffers_written=(("C", 0),),
                                   bytes=8 * 6 * 4,
                                   payload=mod.SliceRef("C", 0)))
            sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag=f"DGEMM[{h}]",
                               stream=0, buffers_read=(("A", 0), ("B", 0)),
                               buffers_written=(("C", 0),),
                               flops=2 * 8 * 6 * 8,
                               payload=mod.BlockRef("dgemm", h)))
        sched.issue(mod.Op(kind=mod.OpKind.D2H, tag="R(c)", stream=0,
                           buffers_read=(("C", 0),), bytes=8 * 6 * 4,
                           payload=mod.SliceRef("C", 0)))
        return sched

    sched, rsched = sched_of(T), sched_of(R)
    second = max(i for i, op in enumerate(sched.ops)
                 if op.kind == T.OpKind.COMPUTE)
    ctx = {"alpha": 1.0, "beta": 1.0}
    outs = []
    for plan in (None, TF.FaultPlan(specs=(
            TF.FaultSpec(op=second, cls="compute_nan"),))):
        ex = T.ScheduleExecutor(torch_device=CPU)
        out = {"C": torch.from_numpy(C.copy())}
        ex.run(sched, {"A": A, "B": B}, out, ctx, faults=plan,
               policy=TF.FaultPolicy(**_quiet()))
        outs.append(out["C"])
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[1].numpy(), A @ B + C, rtol=1e-5,
                               atol=1e-5)
    st = ex.last_fault_stats
    assert st["replayed_ops"] == len(TF.redo_set(sched, second)) == 2
    # C0's clean contents, and A0/B0's first halves, were cloned and held
    # together until C0's write-back
    assert ex.last_snapshot_bytes == (8 * 6 + 8 * 8 + 8 * 6) * 4
    rex = R.ScheduleExecutor()
    rout = {"C": C.copy()}
    rex.run(rsched, {"A": A, "B": B}, rout, ctx,
            faults=_same_plan(TF.FaultPlan(specs=(TF.FaultSpec(
                op=second, cls="compute_nan"),)), RF),
            policy=RF.FaultPolicy(**_quiet()))
    assert rex.last_fault_stats == st
    np.testing.assert_allclose(outs[1].numpy(), rout["C"], rtol=1e-5,
                               atol=1e-5)


def test_integer_operands_recover_exactly():
    """Integer buffers are poisoned with 0 (the reference's NaN-filled
    integer array) and recover exactly."""
    rng = np.random.default_rng(12)
    A = rng.integers(-5, 6, (256, 64)).astype(np.int32)
    B = rng.integers(-5, 6, (64, 192)).astype(np.int32)
    C = rng.integers(-5, 6, (256, 192)).astype(np.int32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 3
    got = T.ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget,
                     faults=lambda s: TF.FaultPlan.random(5, s, 0.5),
                     fault_policy=TF.FaultPolicy(**_quiet()),
                     torch_device=CPU)
    want = R.ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget,
                      faults=lambda s: RF.FaultPlan.random(5, s, 0.5),
                      fault_policy=RF.FaultPolicy(**_quiet()))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), A @ B + C)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------- flush regression
def _flaky_land(monkeypatch, fails):
    """The port's host store of a landing write-back raises
    ``TransferError`` ``fails`` times before it succeeds."""
    real = T_runtime._land
    left = {"n": fails}

    def land(dest, arr, ref):
        if left["n"] > 0:
            left["n"] -= 1
            raise TF.TransferError("transient write-back failure")
        real(dest, arr, ref)

    monkeypatch.setattr(T_runtime, "_land", land)


def test_flush_exception_keeps_block_in_flight_and_retries(monkeypatch):
    A, B, C, part, sched, *_ = _gemm_case()
    clean = _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched)
    slept, sleep = _fake_clock()
    _flaky_land(monkeypatch, 1)
    rt = _rt()
    # an empty plan arms fault mode (retrying flushes) with no injection
    out = rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched,
                  faults=TF.FaultPlan(), policy=TF.FaultPolicy(sleep=sleep))
    assert torch.equal(out, clean)
    st = rt.executor.last_fault_stats
    assert st["injected"] == 0 and st["retries"] == 1
    assert st["recovered_retry"] == 1 and len(slept) == 1


def test_flush_exception_without_policy_propagates(monkeypatch):
    A, B, C, part, sched, *_ = _gemm_case()
    _flaky_land(monkeypatch, 1)
    with pytest.raises(TF.TransferError):
        _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched)


def test_flush_retries_exhaust_and_raise(monkeypatch):
    A, B, C, part, sched, *_ = _gemm_case()
    _flaky_land(monkeypatch, 4)
    rt = _rt()
    with pytest.raises(TF.TransferError):
        rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched,
                faults=TF.FaultPlan(),
                policy=TF.FaultPolicy(**_quiet(max_retries=3)))
    assert rt.executor.last_fault_stats["retries"] == 3


# --------------------------------------------------------- device_lost / oom
@pytest.mark.parametrize("cls,err", [("device_lost", "DeviceLostError"),
                                     ("oom", "OomError")])
def test_device_lost_and_oom_outside_the_ladders_propagate(cls, err):
    A, B, C, part, sched, *_ = _gemm_case()
    ci = _first(sched, "COMPUTE")
    rt = _rt()
    with pytest.raises(getattr(TF, err)):
        rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched,
                faults=TF.FaultPlan(specs=(TF.FaultSpec(op=ci, cls=cls),)))
    assert rt.executor.last_fault_stats["injected"] == 1


def _oom_at_first_compute(mod, times=1):
    def factory(sched):
        i = next(i for i, op in enumerate(sched.ops)
                 if op.kind.name == "COMPUTE")
        return mod.FaultPlan(specs=(mod.FaultSpec(op=i, cls="oom",
                                                  times=times),))
    return factory


@pytest.mark.parametrize("times", [1, 10])
def test_oom_untuned_gemm_halves_nbuf_first_and_stays_bitwise(times):
    """The degraded re-run is fault-free by design, so even an oom with 9
    occurrences left recovers on the first rung."""
    rng = np.random.default_rng(5)
    m, n, k = 128, 48, 32
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C = rng.standard_normal((m, n))
    clean = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=60_000,
                       torch_device=CPU)
    pol = TF.FaultPolicy(**_quiet())
    out = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=60_000,
                     faults=_oom_at_first_compute(TF, times),
                     fault_policy=pol, torch_device=CPU)
    assert [d.action for d in pol.degrades] == ["halve_nbuf"]
    assert torch.equal(out, clean)
    rpol = RF.FaultPolicy(**_quiet())
    rout = R.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=60_000,
                      faults=_oom_at_first_compute(RF, times),
                      fault_policy=rpol)
    assert [vars(d) for d in pol.degrades] == [vars(d) for d in
                                               rpol.degrades]
    np.testing.assert_allclose(out.numpy(), rout, rtol=RTOL, atol=ATOL)


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def test_oom_cholesky_and_lu_degrade_and_stay_correct():
    rng = np.random.default_rng(8)
    n = 192
    spd = _spd(rng, n)
    budget = 4 * spd.nbytes
    kw = dict(panel=64, budget_bytes=budget)
    pol = TF.FaultPolicy(**_quiet())
    clean_l = T.ooc_cholesky(spd, torch_device=CPU, **kw)
    L = T.ooc_cholesky(spd, faults=_oom_at_first_compute(TF),
                       fault_policy=pol, torch_device=CPU, **kw)
    assert [d.action for d in pol.degrades] == ["halve_nbuf"]
    assert torch.equal(L, clean_l)
    ref_l = R.ooc_cholesky(spd, **kw)
    assert np.abs(L.numpy() - ref_l).max() <= 5e-6 * np.abs(ref_l).max()

    pol2 = TF.FaultPolicy(**_quiet())
    B = rng.standard_normal((n, n)) + n * np.eye(n)
    clean_lu, clean_p = T.ooc_lu(B, torch_device=CPU, **kw)
    LU, perm = T.ooc_lu(B, faults=_oom_at_first_compute(TF),
                        fault_policy=pol2, torch_device=CPU, **kw)
    assert [d.action for d in pol2.degrades] == ["halve_nbuf"]
    assert torch.equal(LU, clean_lu) and torch.equal(perm, clean_p)
    rpol2 = RF.FaultPolicy(**_quiet())
    ref_lu, ref_p = R.ooc_lu(B, faults=_oom_at_first_compute(RF),
                             fault_policy=rpol2, **kw)
    assert [vars(d) for d in pol2.degrades] == [vars(d) for d in
                                                rpol2.degrades]
    assert np.array_equal(perm.numpy(), ref_p)
    np.testing.assert_allclose(LU.numpy(), ref_lu, rtol=0,
                               atol=1e-4 * np.abs(ref_lu).max())


def test_oom_ladder_replans_at_halved_budgets_as_the_reference():
    """With nbuf=1 and lookahead=0 the ladder is budget halvings only; at
    half the budget the planner halves the panel, and the degraded
    factor equals the reference's degraded factor at its tolerance."""
    rng = np.random.default_rng(9)
    n = 64
    spd = _spd(rng, n)
    budget = T.factor_pipeline_spec(n, 16, 1 << 20, 8, kind="cholesky",
                                    lookahead=0, nbuf=1).working_set_bytes(1)
    kw = dict(panel=16, budget_bytes=budget, lookahead=0, nbuf=1)
    pol = TF.FaultPolicy(**_quiet())
    L = T.ooc_cholesky(spd, faults=_oom_at_first_compute(TF),
                       fault_policy=pol, torch_device=CPU, **kw)
    rpol = RF.FaultPolicy(**_quiet())
    ref = R.ooc_cholesky(spd, faults=_oom_at_first_compute(RF),
                         fault_policy=rpol, **kw)
    assert [vars(d) for d in pol.degrades] == [vars(d) for d in
                                               rpol.degrades]
    assert pol.degrades[0].action == "halve_budget"
    assert np.abs(L.numpy() - ref).max() <= 5e-6 * np.abs(ref).max()


def test_oom_ladder_exhaustion_raises():
    """Every rung's budget too small to plan: each is recorded, skipped,
    and the oom propagates, as in the reference."""
    from repro_torch.core.ooc_factor import _run_factor_resilient

    rng = np.random.default_rng(10)
    spd = _spd(rng, 64)
    spec = T.factor_pipeline_spec(64, 16, 1 << 20, 8, kind="cholesky",
                                  lookahead=0, nbuf=1)
    pol = TF.FaultPolicy(**_quiet())
    with pytest.raises(TF.OomError):
        _run_factor_resilient(
            torch.from_numpy(spd), "cholesky", spec, 2, 1, False, "lru",
            faults=_oom_at_first_compute(TF), policy=pol, panel=16,
            budget_bytes=64, executor=None, torch_device=CPU)
    rspec = R.factor_pipeline_spec(64, 16, 1 << 20, 8, kind="cholesky",
                                   lookahead=0, nbuf=1)
    rpol = RF.FaultPolicy(**_quiet())
    with pytest.raises(RF.OomError):
        R_factor._run_factor_resilient(
            spd, "cholesky", rspec, 2, 1, False, "lru", None,
            faults=_oom_at_first_compute(RF), policy=rpol, panel=16,
            budget_bytes=64, bpe=8, dtype=spd.dtype, tune=None, tuner=None)
    assert [d.action for d in pol.degrades] == ["halve_budget"] * 2
    assert [vars(d) for d in pol.degrades] == [vars(d) for d in
                                               rpol.degrades]


# ------------------------------------------------- the factorizations
def _factor_run(mod, kind, A, budget, panel, **kw):
    """The factorization's entry point of ``mod``; returns (result, the
    executor that ran it)."""
    if mod is T:
        ex = T.ScheduleExecutor(torch_device=CPU)
        fn = T.ooc_cholesky if kind == "cholesky" else T.ooc_lu
        return fn(A, panel=panel, budget_bytes=budget, executor=ex,
                  torch_device=CPU, **kw), ex
    made = []

    class Keep(R.ScheduleExecutor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    real = R_factor.ScheduleExecutor
    R_factor.ScheduleExecutor = Keep
    try:
        fn = R.ooc_cholesky if kind == "cholesky" else R.ooc_lu
        res = fn(A, panel=panel, budget_bytes=budget, **kw)
    finally:
        R_factor.ScheduleExecutor = real
    return res, made[-1]


def _factor_input(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "cholesky":
        return _spd(rng, n)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _factor_close(kind, got, want):
    if kind == "cholesky":
        assert np.abs(got.numpy() - want).max() <= 5e-6 * np.abs(want).max()
        return
    (LU, perm), (rLU, rperm) = got, want
    assert np.array_equal(perm.numpy(), rperm)
    np.testing.assert_allclose(LU.numpy(), rLU, rtol=0,
                               atol=1e-4 * np.abs(rLU).max())


def _equal(kind, a, b):
    if kind == "cholesky":
        return torch.equal(a, b)
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind,seed", [("cholesky", 21), ("lu", 22)])
def test_factor_compute_and_transfer_faults_recover_bitwise(kind, seed):
    n, panel = 192, 64
    A = _factor_input(kind, n, seed - 12)
    budget = 4 * A.nbytes
    clean, _ = _factor_run(T, kind, A, budget, panel)
    got, ex = _factor_run(T, kind, A, budget, panel,
                          faults=lambda s: TF.FaultPlan.random(seed, s, 0.3),
                          fault_policy=TF.FaultPolicy(**_quiet()))
    assert _equal(kind, got, clean)
    ref, rex = _factor_run(R, kind, A, budget, panel,
                           faults=lambda s: RF.FaultPlan.random(seed, s, 0.3),
                           fault_policy=RF.FaultPolicy(**_quiet()))
    assert ex.last_fault_stats == rex.last_fault_stats
    assert ex.last_fault_stats["injected"] > 0
    _factor_close(kind, got, ref)


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factor_replay_at_every_compute_op(kind):
    """A compute fault at each replayable op of a small factor schedule —
    the panel ops (POTRF/TRSM, GETRF with its pivots re-parked, the LU row
    TRSM) and the trailing ``dgemm`` blocks — recovers bit for bit, with
    the reference's record and the static redo-set's length."""
    n, panel = 96, 32
    A = _factor_input(kind, n, 30)
    budget = 4 * A.nbytes
    spec = T.factor_pipeline_spec(n, panel, budget, 8, kind=kind)
    sched = T.compile_factor_pipeline(spec)
    clean, _ = _factor_run(T, kind, A, budget, panel)
    kernels = set()
    for ci, op in enumerate(sched.ops):
        if op.kind != T.OpKind.COMPUTE or \
                op.payload.kernel not in TF.REPLAYABLE_KERNELS:
            continue
        kernels.add(op.payload.kernel)
        got, ex = _factor_run(T, kind, A, budget, panel, faults=TF.FaultPlan(
            specs=(TF.FaultSpec(op=ci, cls="compute_nan"),)),
            fault_policy=TF.FaultPolicy(**_quiet()))
        assert _equal(kind, got, clean), f"replay at op {ci} diverged"
        st = ex.last_fault_stats
        assert st["replayed_ops"] == len(TF.redo_set(sched, ci))
        _, rex = _factor_run(R, kind, A, budget, panel, faults=RF.FaultPlan(
            specs=(RF.FaultSpec(op=ci, cls="compute_nan"),)),
            fault_policy=RF.FaultPolicy(**_quiet()))
        assert st == rex.last_fault_stats
    assert kernels == ({"panel_chol", "panel_trsm", "dgemm"}
                       if kind == "cholesky"
                       else {"panel_lu", "lu_trsm", "dgemm"})


def test_syrk_faults_match_reference():
    rng = np.random.default_rng(2000)
    m, k = 128, 32
    P = rng.standard_normal((m, k))
    C = rng.standard_normal((m, m))
    C = C + C.T
    budget = 100_000
    clean = T.ooc_syrk(P, C, 1.0, 0.5, budget_bytes=budget,
                       torch_device=CPU)
    rt = _rt()
    got = T.ooc_syrk(P, C, 1.0, 0.5, budget_bytes=budget, runtime=rt,
                     faults=lambda s: TF.FaultPlan.random(4, s, 0.4),
                     fault_policy=TF.FaultPolicy(**_quiet()))
    assert torch.equal(got, clean)
    rrt = R.HostOocRuntime()
    want = R.ooc_syrk(P, C, 1.0, 0.5, budget_bytes=budget, runtime=rrt,
                      faults=lambda s: RF.FaultPlan.random(4, s, 0.4),
                      fault_policy=RF.FaultPolicy(**_quiet()))
    assert rt.executor.last_fault_stats == rrt.executor.last_fault_stats
    assert rt.executor.last_fault_stats["injected"] > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------- device_lost oracle
HYBRID_FAST = dict(nbuf_options=(1, 2), max_steps=256)


def _hybrid_devices(budget, mod=TH):
    import repro.tune as RT
    import repro_torch.tune as TT

    tune = TT if mod is TH else RT
    return [mod.DeviceSpec("gpu0", tune.gpu_profile(), budget),
            mod.DeviceSpec("phi0", tune.phi_profile(), budget)]


def _first_compute_lost(sched, mod=TF):
    for i, op in enumerate(sched.ops):
        if op.kind.name == "COMPUTE":
            return mod.FaultPlan(specs=(mod.FaultSpec(op=i,
                                                      cls="device_lost"),))
    raise AssertionError("schedule has no compute op")


def test_device_lost_gemm_rebalances_bitwise():
    rng = np.random.default_rng(3)
    m, n, k = 512, 256, 128
    budget = (m * k + k * n + m * n) * 4 // 3
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, n)).astype(np.float32)
    C = rng.standard_normal((m, n)).astype(np.float32)
    hp = TH.plan_hybrid_gemm(m, n, k, _hybrid_devices(budget),
                             **HYBRID_FAST)
    clean, _ = TH.run_hybrid_gemm(A, B, C, 1.2, 0.5, hp, torch_device=CPU)
    rhp = RH.plan_hybrid_gemm(m, n, k, _hybrid_devices(budget, RH),
                              **HYBRID_FAST)
    rclean, _ = RH.run_hybrid_gemm(A, B, C, 1.2, 0.5, rhp)
    pol = TF.FaultPolicy(sleep=lambda s: None)
    for dead in ("gpu0", "phi0"):
        out, groups = TH.run_hybrid_gemm(
            A, B, C, 1.2, 0.5, hp, fault_plans={dead: _first_compute_lost},
            fault_policy=pol, torch_device=CPU)
        # bitwise vs the fault-free hybrid run (K is never split, so the
        # rebalanced band's blocks are the same full-depth dots)...
        assert torch.equal(out, clean)
        # ...and vs the reference's rebalanced run and the dense oracle
        rout, rgroups = RH.run_hybrid_gemm(
            A, B, C, 1.2, 0.5, rhp,
            fault_plans={dead: lambda s: _first_compute_lost(s, RF)},
            fault_policy=RF.FaultPolicy(sleep=lambda s: None))
        np.testing.assert_allclose(out.numpy(), rout, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), rclean, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(gemm_ref(A, B, C, 1.2, 0.5)),
            rtol=1e-5, atol=1e-5)
        names = [g[0] for g in groups]
        survivor = "phi0" if dead == "gpu0" else "gpu0"
        assert any(f"rebalance {dead}" in nm for nm in names)
        assert dead not in names and survivor in names
        assert names == [g[0] for g in rgroups]
        stats = TH.executor.last_run_stats()
        assert stats["lost"] == [dead]
        (reb,) = stats["rebalanced"]
        assert reb["device"] == dead
        assert reb["h2d_bytes"] == reb["sched_h2d_bytes"]
        assert reb["d2h_bytes"] == reb["sched_d2h_bytes"]


def test_device_lost_syrk_recovers_via_gemm_band():
    rng = np.random.default_rng(4)
    m, k = 512, 128
    budget = (m * k + k * m + m * m) * 4 // 3
    P = rng.standard_normal((m, k)).astype(np.float32)
    C = rng.standard_normal((m, m)).astype(np.float32)
    C = C + C.T
    hp = TH.plan_hybrid_syrk(m, k, _hybrid_devices(budget), **HYBRID_FAST)
    clean, _ = TH.run_hybrid_syrk(P, C, 1.2, 0.5, hp, torch_device=CPU)
    out, groups = TH.run_hybrid_syrk(
        P, C, 1.2, 0.5, hp, fault_plans={"gpu0": _first_compute_lost},
        fault_policy=TF.FaultPolicy(sleep=lambda s: None), torch_device=CPU)
    # the port's hybrid SYRK is bitwise against its clean hybrid run and
    # its single-device SYRK; the reference's only within its tolerance
    assert torch.equal(out, clean)
    assert torch.equal(out, T.ooc_syrk(P, C, 1.2, 0.5, budget_bytes=budget,
                                       torch_device=CPU))
    assert [g[0] for g in groups] == ["phi0", "phi0 (rebalance gpu0)"]
    rhp = RH.plan_hybrid_syrk(m, k, _hybrid_devices(budget, RH),
                              **HYBRID_FAST)
    rout, _ = RH.run_hybrid_syrk(
        P, C, 1.2, 0.5, rhp,
        fault_plans={"gpu0": lambda s: _first_compute_lost(s, RF)},
        fault_policy=RF.FaultPolicy(sleep=lambda s: None))
    np.testing.assert_allclose(out.numpy(), rout, rtol=RTOL, atol=ATOL)


def test_surviving_devices_validation():
    devs = _hybrid_devices(1 << 20)
    assert [d.name for d in TH.surviving_devices(devs, ["gpu0"])] \
        == ["phi0"]
    for mod, ds in ((TH, devs), (RH, _hybrid_devices(1 << 20, RH))):
        with pytest.raises(ValueError, match="not in device set"):
            mod.surviving_devices(ds, ["nope"])
        with pytest.raises(ValueError, match="no survivors"):
            mod.surviving_devices(ds, ["gpu0", "phi0"])


def test_device_lost_late_in_the_band_rebalances_bitwise():
    """gpu0 is lost at its last compute, after most of its band has been
    written back into the output (``beta != 0``, so a band that did not
    restart from the pristine C would show): the survivors recompute the
    whole band, bit for bit equal to the clean run."""
    rng = np.random.default_rng(5)
    m, n, k = 512, 256, 128
    budget = (m * k + k * n + m * n) * 4 // 3
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, n)).astype(np.float32)
    C = rng.standard_normal((m, n)).astype(np.float32)
    hp = TH.plan_hybrid_gemm(m, n, k, _hybrid_devices(budget),
                             **HYBRID_FAST)
    clean, _ = TH.run_hybrid_gemm(A, B, C, 1.0, 1.0, hp, torch_device=CPU)
    dp = next(d for d in hp.device_plans if d.device.name == "gpu0")
    last = max(i for i, op in enumerate(TH.device_schedule(hp, dp).ops)
               if op.kind.name == "COMPUTE")
    out, groups = TH.run_hybrid_gemm(
        A, B, C, 1.0, 1.0, hp,
        fault_plans={"gpu0": TF.FaultPlan(specs=(
            TF.FaultSpec(op=last, cls="device_lost"),))},
        fault_policy=TF.FaultPolicy(sleep=lambda s: None), torch_device=CPU)
    assert torch.equal(out, clean)
    assert [g[0] for g in groups] == ["phi0", "phi0 (rebalance gpu0)"]


# ------------------------------------------------------- entry-point rules
def test_faults_rejected_on_non_host_backends():
    rng = np.random.default_rng(10)
    A = rng.standard_normal((64, 32))
    B = rng.standard_normal((32, 48))
    spd = A @ A.T + 64 * np.eye(64)
    for call in (
            lambda: T.ooc_gemm(A, B, None, 1.0, 0.0, budget_bytes=1 << 20,
                               backend="vmem", faults=TF.FaultPlan(),
                               torch_device=CPU),
            lambda: T.ooc_gemm(A, B, budget_bytes=1 << 20,
                               devices=[("gpu0", None, 1 << 20)],
                               faults=TF.FaultPlan(), torch_device=CPU),
            lambda: T.ooc_syrk(A, budget_bytes=1 << 20, backend="mesh",
                               faults=TF.FaultPlan(), torch_device=CPU),
            lambda: T.ooc_cholesky(spd, panel=32, budget_bytes=1 << 20,
                                   devices=[("gpu0", None, 1 << 20)],
                                   faults=TF.FaultPlan(), torch_device=CPU),
            lambda: T.ooc_lu(spd, panel=32, budget_bytes=1 << 20,
                             backend="vmem", faults=TF.FaultPlan(),
                             torch_device=CPU)):
        with pytest.raises(ValueError, match="host pipeline backend only"):
            call()
    with pytest.raises(ValueError, match="host pipeline backend only"):
        R.ooc_gemm(A, B, None, 1.0, 0.0, budget_bytes=1 << 20,
                   backend="vmem", faults=RF.FaultPlan())


def test_faults_rejected_with_devices():
    """``faults=`` together with ``devices=`` raises the reference's
    ``ValueError`` (hybrid paths take ``fault_plans`` on
    ``run_hybrid_*``), on every entry point that takes both."""
    rng = np.random.default_rng(10)
    A = rng.standard_normal((64, 32))
    spd = A @ A.T + 64 * np.eye(64)
    devs = _hybrid_devices(1 << 20)
    kw = dict(budget_bytes=1 << 20, devices=devs, faults=TF.FaultPlan(),
              torch_device=CPU)
    for call in (lambda: T.ooc_gemm(A, A.T, **kw),
                 lambda: T.ooc_syrk(A, **kw),
                 lambda: T.ooc_cholesky(spd, panel=32, **kw),
                 lambda: T.ooc_lu(spd, panel=32, **kw)):
        with pytest.raises(ValueError, match="host pipeline backend only"):
            call()
    with pytest.raises(ValueError, match="host pipeline backend only"):
        R.ooc_cholesky(spd, panel=32, budget_bytes=1 << 20,
                       devices=_hybrid_devices(1 << 20, RH),
                       faults=RF.FaultPlan())


# ----------------------------------------------------- tuned runs (item 7)
@pytest.fixture
def default_tuners(tmp_path):
    """``tune="auto"`` without ``tuner=`` in both packages on one canned
    profile: each package's default tuner is an ``AutoTuner`` on
    ``gpu_profile()`` with a plan cache under ``tmp_path`` (nothing is
    calibrated, nothing touches the home directory); the defaults are
    restored after the test."""
    import repro.tune as RT
    import repro.tune.tuner as RT_tuner
    import repro_torch.tune as TT
    import repro_torch.tune.tuner as TT_tuner

    saved = (RT_tuner._default_tuner, TT_tuner._default_tuner)
    RT.set_default_tuner(RT.AutoTuner(
        profile=RT.gpu_profile(),
        cache=RT.PlanCache(str(tmp_path / "reference.json"))))
    TT.set_default_tuner(TT.AutoTuner(
        profile=TT.gpu_profile(),
        cache=TT.PlanCache(str(tmp_path / "port.json")), torch_device=CPU))
    yield TT.get_default_tuner()
    RT.set_default_tuner(saved[0])
    TT.set_default_tuner(saved[1])


def test_oom_tuned_gemm_lands_on_reduced_budget_plan(default_tuners):
    rng = np.random.default_rng(6)
    m, n, k = 256, 64, 32
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C = rng.standard_normal((m, n))
    budget = 120_000
    kw = dict(budget_bytes=budget, tune="auto", torch_device=CPU)
    clean = T.ooc_gemm(A, B, C, 1.0, 0.5, **kw)
    pol = TF.FaultPolicy(**_quiet())
    out = T.ooc_gemm(A, B, C, 1.0, 0.5, faults=_oom_at_first_compute(TF),
                     fault_policy=pol, **kw)
    # tuned runs: the tuner owns nbuf/lookahead, so the ladder is budget
    # halvings only, re-searched — the degraded run IS the tuner's plan at
    # the reduced budget
    assert [d.action for d in pol.degrades] == ["halve_budget"]
    assert pol.degrades[0].budget_bytes == budget // 2
    assert torch.equal(out, clean)
    direct = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=budget // 2,
                        tune="auto", torch_device=CPU)
    assert torch.equal(out, direct)
    assert default_tuners.searches == 2 and default_tuners.last_from_cache
    rpol = RF.FaultPolicy(**_quiet())
    rout = R.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=budget, tune="auto",
                      faults=_oom_at_first_compute(RF), fault_policy=rpol)
    assert [vars(d) for d in pol.degrades] == [vars(d) for d in
                                               rpol.degrades]
    np.testing.assert_allclose(out.numpy(), rout, rtol=RTOL, atol=ATOL)


def test_oom_degraded_rerun_is_fault_free_and_ladder_exhaustion_raises(
        default_tuners):
    rng = np.random.default_rng(7)
    m, n, k = 128, 48, 32
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C = rng.standard_normal((m, n))
    clean = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=60_000,
                       torch_device=CPU)
    pol = TF.FaultPolicy(**_quiet())
    out = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=60_000,
                     faults=_oom_at_first_compute(TF, 10), fault_policy=pol,
                     torch_device=CPU)
    assert [d.action for d in pol.degrades] == ["halve_nbuf"]
    assert torch.equal(out, clean)

    # tuned ladder at this budget: both halvings (30k, 15k) are below the
    # 53248B aligned working-set floor, so every rung fails to replan and
    # the oom propagates to the caller, as in the reference
    pols = []
    for mod, err, call in (
            (TF, TF.OomError, lambda **kw: T.ooc_gemm(
                A, B, C, 1.0, 0.5, torch_device=CPU, **kw)),
            (RF, RF.OomError, lambda **kw: R.ooc_gemm(
                A, B, C, 1.0, 0.5, **kw))):
        pols.append(mod.FaultPolicy(**_quiet(max_budget_halvings=2)))
        with pytest.raises(err):
            call(budget_bytes=60_000, tune="auto",
                 faults=_oom_at_first_compute(mod, 10),
                 fault_policy=pols[-1])
    assert [d.action for d in pols[0].degrades] == ["halve_budget"] * 2
    assert [vars(d) for d in pols[0].degrades] == [vars(d) for d in
                                                   pols[1].degrades]


def test_search_ranks_under_fault_model():
    import repro.tune as RT
    import repro_torch.tune as TT

    prof = TT.gpu_profile()
    best = TT.search_gemm(512, 256, 128, 1 << 22, prof)
    faulted = TT.search_gemm(512, 256, 128, 1 << 22, prof, fault_rate=0.05)
    assert faulted.makespan >= best.makespan
    # the policy bridge produces the same model the tuner consumes
    pol = TF.FaultPolicy(backoff_base=0.02)
    fm = pol.fault_model(0.05)
    assert fm.rate == 0.05 and fm.mean_backoff == 0.02
    via_model = TT.search_gemm(512, 256, 128, 1 << 22, prof, fault_model=fm)
    assert via_model.makespan >= best.makespan
    # plan for plan the reference's, makespans included
    rprof = RT.gpu_profile()
    for got, want in (
            (best, RT.search_gemm(512, 256, 128, 1 << 22, rprof)),
            (faulted, RT.search_gemm(512, 256, 128, 1 << 22, rprof,
                                     fault_rate=0.05)),
            (via_model, RT.search_gemm(
                512, 256, 128, 1 << 22, rprof,
                fault_model=RF.FaultPolicy(backoff_base=0.02).fault_model(
                    0.05)))):
        assert got.to_json() == want.to_json()


def _tuned_call(mod, entry, A, **kw):
    """``entry`` of ``mod`` with ``tune="auto"`` on its default tuner; the
    executor that ran it rides along (the port's by argument, the
    reference's through its runtime or the factor helper)."""
    if entry in ("ooc_gemm", "ooc_syrk"):
        if mod is T:
            rt = _rt()
        else:
            rt = R.HostOocRuntime()
        args = (A, A.T.copy(), A) if entry == "ooc_gemm" else (A,)
        out = getattr(mod, entry)(*args, budget_bytes=A.nbytes * 3 // 2,
                                  tune="auto", runtime=rt, **kw)
        return out, rt.executor
    return _factor_run(mod, entry[4:], A, A.nbytes // 2, 32, tune="auto",
                       **kw)


@pytest.mark.parametrize("entry", ["ooc_gemm", "ooc_syrk", "ooc_cholesky",
                                   "ooc_lu"])
def test_tune_auto_with_faults_recovers_bitwise(default_tuners, entry):
    """``tune="auto"`` with ``faults=``: transfer retries and compute
    replays recover on the tuned schedule, the result equals the clean
    tuned run bit for bit, and ``last_fault_stats`` equals the
    reference's on its tuned schedule under the same seeded plan (the two
    tuners pick the same plan)."""
    rng = np.random.default_rng(31)
    n = 256
    A = _spd(rng, n) if entry == "ooc_cholesky" \
        else rng.standard_normal((n, n)) + n * np.eye(n)

    def plan(mod):
        return lambda sched: mod.FaultPlan.random(3, sched, 0.3)

    clean, _ = _tuned_call(T, entry, A)
    out, ex = _tuned_call(T, entry, A, faults=plan(TF),
                          fault_policy=TF.FaultPolicy(**_quiet()))
    assert default_tuners.last_from_cache and default_tuners.searches == 1
    clean, out = (c if isinstance(c, tuple) else (c,) for c in (clean, out))
    assert all(torch.equal(a, b) for a, b in zip(out, clean))
    assert ex.last_fault_stats["injected"] > 0
    ref, rex = _tuned_call(R, entry, A, faults=plan(RF),
                           fault_policy=RF.FaultPolicy(**_quiet()))
    assert ex.last_fault_stats == rex.last_fault_stats
    ref = ref if isinstance(ref, tuple) else (ref,)
    scale = np.abs(np.asarray(ref[0])).max()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-4 * scale)


def test_in_core_path_and_a_lone_policy_ignore_faults():
    """The in-core fast path ignores ``faults=``, and ``fault_policy=``
    without ``faults=`` arms nothing, as in the reference."""
    A, B, C, *_ = _gemm_case()
    plan = TF.FaultPlan(specs=(TF.FaultSpec(op=0, cls="oom"),))
    big = T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=1 << 30, faults=plan,
                     torch_device=CPU)
    assert torch.equal(big, T.ooc_gemm(A, B, C, 1.0, 0.5,
                                       budget_bytes=1 << 30,
                                       torch_device=CPU))
    rt = _rt()
    T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=60_000, runtime=rt,
               fault_policy=TF.FaultPolicy())
    assert rt.executor.last_fault_stats is None


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_faulted_runs_agree_across_modes(mode):
    case = _gemm_case()
    A, B, C, part, sched, *_ = case
    clean = _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched)
    rt = _rt(T.ScheduleExecutor(mode=mode, torch_device=CPU,
                                record_spans=True))
    out = rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched,
                  faults=TF.FaultPlan.random(9, sched, 0.5),
                  policy=TF.FaultPolicy(**_quiet()))
    assert torch.equal(out, clean)
    assert rt.executor.last_completion_order == list(range(len(sched.ops)))
    assert [s[0] for s in rt.executor.last_spans] \
        == [op.tag for op in sched.ops]


# --------------------------------------------- simulator + obs + facade
def test_fault_model_expected_durations_match_reference():
    from repro.core.simulator import FaultModel as R_FM
    from repro_torch.core.simulator import FaultModel as T_FM

    *_, sched, _, rsched = _gemm_case()
    hw, rhw = T.gpu_like(), R.gpu_like()
    for rate in (0.0, 0.1, 0.5):
        fm = T_FM(rate=rate, mean_backoff=0.01, redo_factor=2.0)
        rfm = R_FM(rate=rate, mean_backoff=0.01, redo_factor=2.0)
        for op, rop in zip(sched.ops, rsched.ops):
            dur = hw.duration(op)
            assert dur == rhw.duration(rop)
            assert fm.expected_duration(op, dur) \
                == rfm.expected_duration(rop, dur)
        span = T.simulate(sched, hw, faults=fm).makespan
        assert span == R.simulate(rsched, rhw, faults=rfm).makespan


def test_fault_metrics_published_and_facade():
    case = _gemm_case()
    A, B, C, part, sched, rpart, rsched = case
    h2d = _first(sched, "H2D")
    ci = _first(sched, "COMPUTE")
    plan = TF.FaultPlan(specs=(TF.FaultSpec(op=h2d, cls="h2d_error"),
                               TF.FaultSpec(op=ci, cls="compute_nan")))
    pol = hclFaultPolicy(sleep=lambda s: None)
    assert isinstance(pol, TF.FaultPolicy)
    obs = get_observability().enable(metrics=True)
    _rt().gemm(A, B, C, 1.0, 0.5, part, schedule=sched, faults=plan,
               policy=pol)
    text = obs.metrics.to_prometheus_text()
    assert "repro_fault_injected_total" in text
    assert "repro_fault_retries_total" in text
    assert "repro_fault_replayed_ops_total" in text
    assert 'action="retry"' in text and 'action="replay"' in text
    robs = R_obs().enable(metrics=True)
    R.HostOocRuntime().gemm(A, B, C, 1.0, 0.5, rpart, schedule=rsched,
                            faults=_same_plan(plan, RF),
                            policy=R_hclFaultPolicy(sleep=lambda s: None))
    def family(o):
        return [f for f in o.metrics.snapshot()["metrics"]
                if f["name"].startswith("repro_fault_")]

    assert family(obs) == family(robs) != []
    # the degrade action lands in the same family
    obs.record_fault_recovery("gemm", "degrade")
    assert obs.metrics.get("repro_fault_recoveries_total").value(
        kernel="gemm", action="degrade") == 1


def test_executor_counters_reconcile_with_schedule_stats_under_faults():
    A, B, C, part, sched, *_ = _gemm_case()
    stats = T.schedule_stats(sched)
    rt = _rt()
    plan = TF.FaultPlan.random(33, sched, 0.4)
    rt.gemm(A, B, C, 1.0, 0.5, part, schedule=sched, faults=plan,
            policy=TF.FaultPolicy(**_quiet()))
    assert rt.executor.last_h2d_bytes == stats["h2d_bytes"]
    assert rt.executor.last_d2h_bytes == stats["d2h_bytes"]
    assert rt.executor.last_fault_stats["injected"] == len(plan)


@pytest.mark.parametrize("entry", ["gemm", "cholesky"])
def test_oom_ladder_frees_the_failed_runs_buffers(monkeypatch, entry):
    """The degraded re-run starts after the failed run's parity buffers are
    freed (the oom's traceback, whose frames hold them, is dropped): on a
    card the re-run then fits where the failed one stood."""
    import weakref

    real = T_runtime.ScheduleExecutor._allocate
    held = []

    def allocate(self, sched, st):
        alive = sum(1 for r in held if r() is not None)
        flat = real(self, sched, st)
        held.extend(weakref.ref(t) for t in flat.values())
        allocate.alive_at.append(alive)
        return flat

    allocate.alive_at = []
    monkeypatch.setattr(T_runtime.ScheduleExecutor, "_allocate", allocate)
    rng = np.random.default_rng(13)
    pol = TF.FaultPolicy(**_quiet())
    if entry == "gemm":
        A, B, C = (rng.standard_normal(s) for s in ((128, 32), (32, 48),
                                                    (128, 48)))
        T.ooc_gemm(A, B, C, budget_bytes=60_000, torch_device=CPU,
                   faults=_oom_at_first_compute(TF), fault_policy=pol)
    else:
        T.ooc_cholesky(_spd(rng, 96), panel=32, budget_bytes=1 << 20,
                       torch_device=CPU, faults=_oom_at_first_compute(TF),
                       fault_policy=pol)
    assert len(allocate.alive_at) == 2 and allocate.alive_at[1] == 0


def test_simulate_faulted_makespan_monotone_in_rate():
    """The expected-cost simulation under a fault rate: the reference's
    makespan at every rate, rising with the rate."""
    from repro.core.simulator import FaultModel as R_FaultModel
    from repro_torch.core.simulator import FaultModel

    *_, sched, _, rsched = _gemm_case()
    hw, rhw = T.gpu_like(), R.gpu_like()
    base = T.simulate(sched, hw).makespan
    assert base == R.simulate(rsched, rhw).makespan
    prev = base
    for rate in (0.01, 0.05, 0.2):
        span = T.simulate(sched, hw, faults=FaultModel(rate=rate)).makespan
        assert span == R.simulate(rsched, rhw,
                                  faults=R_FaultModel(rate=rate)).makespan
        assert span > prev * (1 - 1e-12)
        prev = span
    assert prev > base
