"""Conformance fuzzing of the port's fault recovery against the reference.

Twin of ``test_fault_fuzz.py``: for every ``(seed, kernel)`` pair the port
and the reference run the same ``FaultPlan.random`` on the same numpy
inputs (``torch_device="cpu"``, one BLAS thread).  The invariant is the
reference's, held inside the port: the recovered run equals the port's
fault-free run bit for bit, the nominal byte counters reconcile with
``schedule_stats``, and every planned fault was consumed.  Across the
packages: the plan's specs, the injections and ``last_fault_stats`` are
equal, and the results agree at the reference's tolerance.  A divergence
shrinks to a minimal failing ``(op, cls)`` through :func:`shrink_plan`
before the assertion fires.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.ooc_factor as R_factor
import repro.fault as RF
import repro_torch.core as T
import repro_torch.fault as TF

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
N_SEEDS = 50
SEEDS = list(range(N_SEEDS))
RATE = 0.25          # executor-level pipelines (gemm / syrk)
FACTOR_RATE = 0.10   # factor schedules are long; keep replay volume sane


def _policy(mod):
    return mod.FaultPolicy(sleep=lambda s: None)


def _host(executor=None):
    return T.HostOocRuntime(T.Device("HBM", 0, 1 << 30), executor=executor,
                            torch_device=None if executor else CPU)


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def gemm_case():
    rng = np.random.default_rng(1000)
    m, n, k = 128, 48, 32
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C = rng.standard_normal((m, n))
    part = T.plan_gemm_partition(m, n, k, 60_000)
    sched = T.build_gemm_schedule(part, nstreams=2, nbuf=2)
    rpart = R.plan_gemm_partition(m, n, k, 60_000)
    rsched = R.build_gemm_schedule(rpart, nstreams=2, nbuf=2)
    clean = _host().gemm(A, B, C, 1.0, 0.5, part, schedule=sched)
    rclean = R.HostOocRuntime().gemm(A, B, C, 1.0, 0.5, rpart,
                                     schedule=rsched)
    np.testing.assert_allclose(clean.numpy(), rclean, rtol=1e-4, atol=1e-4)
    return dict(A=A, B=B, C=C, part=part, sched=sched, rpart=rpart,
                rsched=rsched, clean=clean)


@pytest.fixture(scope="module")
def syrk_case():
    rng = np.random.default_rng(2000)
    m, k = 128, 32
    P = rng.standard_normal((m, k))
    C = rng.standard_normal((m, m))
    C = C + C.T
    part = T.plan_gemm_partition(m, m, k, 100_000)
    sched = T.build_syrk_schedule(part, nstreams=2, nbuf=2)
    rpart = R.plan_gemm_partition(m, m, k, 100_000)
    rsched = R.build_syrk_schedule(rpart, nstreams=2, nbuf=2)
    clean = _host().syrk(P, C, 1.0, 0.5, part, schedule=sched)
    rclean = R.HostOocRuntime().syrk(P, C, 1.0, 0.5, rpart, schedule=rsched)
    np.testing.assert_allclose(clean.numpy(), rclean, rtol=1e-4, atol=1e-4)
    return dict(P=P, C=C, part=part, sched=sched, rpart=rpart,
                rsched=rsched, clean=clean)


def _factor_case(kind, seed):
    rng = np.random.default_rng(seed)
    n = 128
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n) if kind == "cholesky" else A + n * np.eye(n)
    budget = 4 * A.nbytes
    fn = T.ooc_cholesky if kind == "cholesky" else T.ooc_lu
    clean = fn(A, panel=32, budget_bytes=budget, torch_device=CPU)
    return dict(A=A, budget=budget, clean=clean)


@pytest.fixture(scope="module")
def chol_case():
    return _factor_case("cholesky", 3000)


@pytest.fixture(scope="module")
def lu_case():
    return _factor_case("lu", 4000)


# ------------------------------------------------------------ shrink helper
def shrink_plan(plan, fails):
    """Minimal failing sub-plan of ``plan`` under predicate ``fails``.

    Tries every single-spec sub-plan first (the common case: one injection
    breaks recovery); falls back to greedy spec removal when the failure
    needs an interaction.  Returns a plan for which ``fails`` holds with
    no removable spec — for a single-spec result, the exact ``(op, cls)``
    culprit.
    """
    for s in plan.specs:
        single = TF.FaultPlan(specs=(s,), seed=plan.seed)
        if fails(single):
            return single
    cur = plan
    changed = True
    while changed and len(cur.specs) > 1:
        changed = False
        for i in range(len(cur.specs)):
            cand = TF.FaultPlan(specs=cur.specs[:i] + cur.specs[i + 1:],
                                seed=cur.seed)
            if fails(cand):
                cur = cand
                changed = True
                break
    return cur


def test_shrink_finds_single_culprit():
    plan = TF.FaultPlan(specs=tuple(
        TF.FaultSpec(op=i, cls="h2d_error") for i in range(8)))
    got = shrink_plan(plan, lambda p: any(s.op == 5 for s in p.specs))
    assert [(s.op, s.cls) for s in got.specs] == [(5, "h2d_error")]


def test_shrink_preserves_interacting_pair():
    plan = TF.FaultPlan(specs=tuple(
        TF.FaultSpec(op=i, cls="h2d_error") for i in range(6)))

    def fails(p):
        return {1, 4} <= {s.op for s in p.specs}

    got = shrink_plan(plan, fails)
    assert {s.op for s in got.specs} == {1, 4}


# ------------------------------------------------------- executor pipelines
def _reconcile(executor, sched, injected):
    """The byte-accounting invariant every fuzz case must satisfy."""
    stats = T.schedule_stats(sched)
    assert executor.last_h2d_bytes == stats["h2d_bytes"]
    assert executor.last_d2h_bytes == stats["d2h_bytes"]
    expect_replayed = sum(
        sched.ops[i].bytes for i, cls in injected
        if cls == "h2d_error" and sched.ops[i].kind == T.OpKind.H2D)
    fs = executor.last_fault_stats
    assert fs["replayed_h2d_bytes"] == expect_replayed
    assert fs["injected"] == len(injected)


def _keys(plan):
    return [(s.op, s.cls, s.times, s.stream, s.device) for s in plan.specs]


def _fuzz_pipeline(case, seed, kind):
    sched, rsched = case["sched"], case["rsched"]
    plan = TF.FaultPlan.random(seed, sched, RATE)
    rplan = RF.FaultPlan.random(seed, rsched, RATE)
    assert _keys(plan) == _keys(rplan)

    def run(p):
        rt = _host()
        inj = p.injector()
        if kind == "gemm":
            out = rt.gemm(case["A"], case["B"], case["C"], 1.0, 0.5,
                          case["part"], schedule=sched, faults=inj,
                          policy=_policy(TF))
        else:
            out = rt.syrk(case["P"], case["C"], 1.0, 0.5, case["part"],
                          schedule=sched, faults=inj, policy=_policy(TF))
        return out, rt.executor, inj

    out, ex, inj = run(plan)
    assert inj.exhausted()
    _reconcile(ex, sched, inj.injected)
    if not torch.equal(out, case["clean"]):
        minimal = shrink_plan(plan, lambda p: not torch.equal(
            run(p)[0], case["clean"]))
        pytest.fail(
            f"seed {seed}: recovered {kind} diverged; minimal failing "
            f"faults: {[(s.op, s.cls) for s in minimal.specs]}")
    rrt = R.HostOocRuntime()
    rinj = rplan.injector()
    if kind == "gemm":
        rout = rrt.gemm(case["A"], case["B"], case["C"], 1.0, 0.5,
                        case["rpart"], schedule=rsched, faults=rinj,
                        policy=_policy(RF))
    else:
        rout = rrt.syrk(case["P"], case["C"], 1.0, 0.5, case["rpart"],
                        schedule=rsched, faults=rinj, policy=_policy(RF))
    assert inj.injected == rinj.injected
    assert ex.last_fault_stats == rrt.executor.last_fault_stats
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_gemm_recovers_bitwise(gemm_case, seed):
    _fuzz_pipeline(gemm_case, seed, "gemm")


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_syrk_recovers_bitwise(syrk_case, seed):
    _fuzz_pipeline(syrk_case, seed, "syrk")


# -------------------------------------------------------- factor pipelines
class _Capture:
    """``faults=`` factory that hands the executor a prepared injector and
    keeps it (plus the compiled schedule) for post-run reconciliation."""

    def __init__(self, mod, seed, rate):
        self.mod = mod
        self.seed = seed
        self.rate = rate
        self.inj = None
        self.sched = None

    def __call__(self, sched):
        self.sched = sched
        self.inj = self.mod.FaultPlan.random(self.seed, sched,
                                             self.rate).injector()
        return self.inj


def _reference_factor(kind, case, cap):
    """The reference's factorization under ``cap``; returns (result,
    its executor's ``last_fault_stats``)."""
    made = []

    class Keep(R.ScheduleExecutor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    real = R_factor.ScheduleExecutor
    R_factor.ScheduleExecutor = Keep
    try:
        fn = R.ooc_cholesky if kind == "cholesky" else R.ooc_lu
        res = fn(case["A"], panel=32, budget_bytes=case["budget"],
                 faults=cap, fault_policy=_policy(RF))
    finally:
        R_factor.ScheduleExecutor = real
    return res, made[-1].last_fault_stats


def _fuzz_factor(kind, case, seed):
    cap = _Capture(TF, seed, FACTOR_RATE)
    ex = T.ScheduleExecutor(torch_device=CPU)
    fn = T.ooc_cholesky if kind == "cholesky" else T.ooc_lu
    got = fn(case["A"], panel=32, budget_bytes=case["budget"], faults=cap,
             fault_policy=_policy(TF), executor=ex, torch_device=CPU)
    assert cap.inj is not None and cap.inj.exhausted()
    _reconcile(ex, cap.sched, cap.inj.injected)
    clean = case["clean"]
    same = torch.equal(got, clean) if kind == "cholesky" else \
        torch.equal(got[0], clean[0]) and torch.equal(got[1], clean[1])
    assert same, (f"seed {seed}: recovered {kind} diverged; injected "
                  f"{cap.inj.injected}")
    rcap = _Capture(RF, seed, FACTOR_RATE)
    ref, rstats = _reference_factor(kind, case, rcap)
    assert cap.inj.injected == rcap.inj.injected
    assert ex.last_fault_stats == rstats
    if kind == "cholesky":
        assert np.abs(got.numpy() - ref).max() <= 5e-6 * np.abs(ref).max()
    else:
        assert np.array_equal(got[1].numpy(), ref[1])
        np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0,
                                   atol=1e-4 * np.abs(ref[0]).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_cholesky_recovers_bitwise(chol_case, seed):
    _fuzz_factor("cholesky", chol_case, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_lu_recovers_bitwise(lu_case, seed):
    _fuzz_factor("lu", lu_case, seed)
