"""The port's concurrent executor mode on the CPU: the twins of
``tests/test_exec_concurrent.py`` that ``test_torch_executor.py`` and
``test_torch_attention.py`` do not already hold.

On the CPU the port's executor runs both modes synchronously in issue
order (``ScheduleExecutor``'s docstring), so what these twins can show
is the contract both modes share with the reference's: results bit for
bit equal across the modes and within the reference's tolerance of its
results, byte counters equal to ``schedule_stats``, a completion order
that is a linear extension of the dependency order (the reference's
``dependency_edges``, whose port must agree edge for edge), plan-cache
resolution, fault fallback, run-to-run stability and thread-safe metric
publishing.  The device-side concurrency itself (engine streams, CUDA
events, nbuf=1 on one stream) is held on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``'s phase 18.
"""

import dataclasses
import faulthandler
import threading

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.streams as R_streams
import repro_torch.core as T
from repro_torch.core.streams import BlockRef, dependency_edges
from _torch_helpers import one_torch_thread, op_key  # noqa: F401

# stress/deadlock hard timeout (seconds): generous against the ~seconds
# the corpus needs, tight enough that a hang dumps every thread's stack
WATCHDOG_S = 300.0
CPU = "cpu"


def _assert_linear_extension(sched, order):
    """``order`` (issue indices in completion order) covers every op once
    and never completes a dependent before its dependency."""
    n = len(sched.ops)
    assert sorted(order) == list(range(n)), \
        "completion order is not a permutation"
    pos = {op_idx: k for k, op_idx in enumerate(order)}
    _, preds = dependency_edges(sched)
    for succ in range(n):
        for pred in preds[succ]:
            assert pos[pred] < pos[succ], (
                f"{sched.ops[succ].tag} completed before its dependency "
                f"{sched.ops[pred].tag}")


def _run_pair(sched, rsched, operands, make_outputs, ctx, view=None,
              tol=1e-4):
    """Run the port's schedule serial then concurrent: bitwise outputs,
    exact byte counters, completion-order legality; and the reference's
    schedule (op for op the same, edge for edge the same dependencies)
    once, ``view`` of its outputs (default: all of them) within ``tol``
    of the port's, relative to the largest magnitude.  Returns the port's
    serial outputs as numpy."""
    assert [op_key(o) for o in sched.ops] == [op_key(o) for o in rsched.ops]
    assert dependency_edges(sched) == R_streams.dependency_edges(rsched)
    T.validate_schedule(sched)
    stats = T.schedule_stats(sched)
    results = {}
    for mode in ("issue_order", "concurrent"):
        ex = T.ScheduleExecutor(mode=mode, torch_device=CPU)
        outs = {k: torch.from_numpy(v) for k, v in make_outputs().items()}
        ex.run(sched, operands, outs, ctx)
        assert ex.last_h2d_bytes == stats["h2d_bytes"], mode
        assert ex.last_d2h_bytes == stats["d2h_bytes"], mode
        results[mode] = ({k: v.numpy() for k, v in outs.items()}, ex)
    serial, conc = results["issue_order"], results["concurrent"]
    for key in serial[0]:
        assert np.array_equal(serial[0][key], conc[0][key]), (
            f"concurrent output {key!r} diverged from serial")
    _assert_linear_extension(sched, conc[1].last_completion_order)
    assert serial[1].last_completion_order == list(range(len(sched.ops)))
    ref = make_outputs()
    R.ScheduleExecutor().run(rsched, operands, ref, ctx)
    view = view or (lambda x: x)
    for key, want in ref.items():
        want = view(np.asarray(want))
        np.testing.assert_allclose(view(serial[0][key]), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))
    return serial[0]


def _gemm_case(rng, M=256, N=256, K=192, frac=3, **build_kw):
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    kw = dict(nbuf=build_kw.get("nbuf"), nstreams=build_kw.get("nstreams"))
    while True:
        try:
            part = T.plan_gemm_partition(M, N, K, budget, 4, **kw)
            break
        except ValueError:
            # small random shapes (stress sweep) can undershoot the
            # minimum aligned working set; a bigger budget still yields a
            # valid (possibly shallower) OOC schedule
            budget *= 2
    rpart = R.plan_gemm_partition(M, N, K, budget, 4, **kw)
    return (A, B, C, T.build_gemm_schedule(part, **build_kw),
            R.build_gemm_schedule(rpart, **build_kw))


# ------------------------------------------------- corpus conformance
@pytest.mark.parametrize("traversal", ["col", "row", "serpentine"])
@pytest.mark.parametrize("evict", ["lru", "belady"])
def test_gemm_concurrent_matches_serial(traversal, evict):
    rng = np.random.default_rng(11)
    A, B, C, sched, rsched = _gemm_case(rng, nstreams=2, nbuf=2,
                                        traversal=traversal, evict=evict)
    out = _run_pair(sched, rsched, {"A": A, "B": B},
                    lambda: {"C": np.array(C, copy=True)},
                    {"alpha": 1.5, "beta": 0.5})
    assert np.abs(out["C"] - (1.5 * A @ B + 0.5 * C)).max() < 1e-2


@pytest.mark.parametrize("nstreams,nbuf", [(1, 1), (2, 2), (3, 2)])
def test_gemm_concurrent_stream_depth_sweep(nstreams, nbuf):
    rng = np.random.default_rng(12)
    A, B, C, sched, rsched = _gemm_case(rng, nstreams=nstreams, nbuf=nbuf)
    _run_pair(sched, rsched, {"A": A, "B": B},
              lambda: {"C": np.array(C, copy=True)},
              {"alpha": 1.0, "beta": 1.0})


@pytest.mark.parametrize("traversal", ["col", "row"])
def test_syrk_concurrent_matches_serial(traversal):
    rng = np.random.default_rng(13)
    n, K = 256, 192
    P = rng.standard_normal((n, K)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    args = (n, n, K, (2 * P.nbytes + C.nbytes) // 2, 4)
    kw = dict(nstreams=2, nbuf=2, traversal=traversal)
    sched = T.build_syrk_schedule(
        T.plan_gemm_partition(*args, nbuf=2, nstreams=2), **kw)
    rsched = R.build_syrk_schedule(
        R.plan_gemm_partition(*args, nbuf=2, nstreams=2), **kw)
    out = _run_pair(sched, rsched, {"P": P},
                    lambda: {"C": np.array(C, copy=True)},
                    {"alpha": 1.0, "beta": 0.5})
    assert np.abs(out["C"] - (P @ P.T + 0.5 * C)).max() < 1e-2


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factor_concurrent_matches_serial(kind):
    """float64 host data computed in float32, as the reference computes
    it with JAX's 64-bit mode off; the factor (Cholesky's lower triangle,
    LU's packed factors) within ``test_torch_executor.py``'s factor
    tolerances of the reference's."""
    rng = np.random.default_rng(15)
    n = 384
    A = rng.standard_normal((n, n)).astype(np.float64)
    if kind == "cholesky":
        A = A @ A.T + n * np.eye(n)
    args = (n, 128, 3 * n * n * 8, 8)
    spec = T.factor_pipeline_spec(*args, kind=kind)
    sched = T.compile_factor_pipeline(spec, nstreams=2, nbuf=2)
    rsched = R.compile_factor_pipeline(
        R.factor_pipeline_spec(*args, kind=kind), nstreams=2, nbuf=2)
    _run_pair(sched, rsched, {}, lambda: {"A": np.array(A, copy=True)},
              {"alpha": -1.0, "beta": 1.0, "panel": spec.panel,
               "n": spec.n},
              view=np.tril if kind == "cholesky" else None,
              tol=5e-6 if kind == "cholesky" else 1e-4)


def test_concurrent_spans_cover_every_op_and_feed_analysis():
    """record_spans in concurrent mode: one span per op, and the spans are
    consumable by the port's TraceAnalysis wall-clock mode."""
    from repro_torch.obs.analyze import TraceAnalysis

    rng = np.random.default_rng(16)
    A, B, C, sched, _ = _gemm_case(rng, nstreams=2, nbuf=2)
    ex = T.ScheduleExecutor(mode="concurrent", record_spans=True,
                            torch_device=CPU)
    out = {"C": torch.from_numpy(np.array(C, copy=True))}
    ex.run(sched, {"A": A, "B": B}, out, {"alpha": 1.0, "beta": 0.0})
    spans = ex.last_spans
    assert len(spans) == len(sched.ops)
    assert sorted(tag for tag, *_ in spans) \
        == sorted(op.tag for op in sched.ops)
    for _, _, t0, t1 in spans:
        assert t1 >= t0 >= 0.0
    ana = TraceAnalysis.from_spans(sched, spans)
    assert ana.n_ops == len(sched.ops)
    assert ana.h2d_bytes == T.schedule_stats(sched)["h2d_bytes"]


# ------------------------------------------------- ExecutablePlan cache
def test_unknown_kernel_raises_in_concurrent_mode():
    rng = np.random.default_rng(20)
    A, B, C, sched, _ = _gemm_case(rng)
    i = next(idx for idx, op in enumerate(sched.ops)
             if isinstance(op.payload, BlockRef))
    sched.ops[i] = dataclasses.replace(
        sched.ops[i], payload=BlockRef("definitely_not_registered", 0))
    ex = T.ScheduleExecutor(mode="concurrent", torch_device=CPU)
    with pytest.raises(KeyError, match="definitely_not_registered"):
        ex.run(sched, {"A": A, "B": B},
               {"C": torch.from_numpy(np.array(C, copy=True))},
               {"alpha": 1.0, "beta": 0.0})


def test_instance_handlers_override_plan_resolution():
    from repro_torch.core.runtime import _dgemm_handler

    rng = np.random.default_rng(21)
    A, B, C, sched, _ = _gemm_case(rng)
    calls = []

    def spy(st, op, ref):
        calls.append(op.tag)
        _dgemm_handler(st, op, ref)

    T.compile_executable(sched)   # pre-resolve against the global registry
    ex = T.ScheduleExecutor(handlers={"dgemm": spy}, mode="concurrent",
                            torch_device=CPU)
    out = {"C": torch.from_numpy(np.array(C, copy=True))}
    ex.run(sched, {"A": A, "B": B}, out, {"alpha": 1.5, "beta": 0.5})
    assert calls == [op.tag for op in sched.ops
                     if isinstance(op.payload, BlockRef)]
    assert np.abs(out["C"].numpy() - (1.5 * A @ B + 0.5 * C)).max() < 1e-2


def test_faults_fall_back_to_serial_and_recover():
    from repro.fault import FaultPlan as R_FaultPlan, FaultSpec as R_FaultSpec
    from repro_torch.fault import FaultPlan, FaultSpec

    rng = np.random.default_rng(22)
    A, B, C, sched, rsched = _gemm_case(rng)
    ref = _run_pair(sched, rsched, {"A": A, "B": B},
                    lambda: {"C": np.array(C, copy=True)},
                    {"alpha": 1.0, "beta": 1.0})
    h2d = next(i for i, op in enumerate(sched.ops)
               if op.kind == T.OpKind.H2D)
    plan = FaultPlan(specs=(FaultSpec(op=h2d, cls="h2d_error", times=1),))
    ex = T.ScheduleExecutor(mode="concurrent", torch_device=CPU)
    out = {"C": torch.from_numpy(np.array(C, copy=True))}
    ex.run(sched, {"A": A, "B": B}, out, {"alpha": 1.0, "beta": 1.0},
           faults=plan)
    assert ex.last_fault_stats["injected"] == 1
    assert ex.last_fault_stats["recovered_retry"] == 1
    assert np.array_equal(out["C"].numpy(), ref["C"]), \
        "fault fallback must still match the fault-free result"
    rex = R.ScheduleExecutor(mode="concurrent")
    rex.run(rsched, {"A": A, "B": B}, {"C": np.array(C, copy=True)},
            {"alpha": 1.0, "beta": 1.0},
            faults=R_FaultPlan(specs=(R_FaultSpec(op=h2d, cls="h2d_error",
                                                  times=1),)))
    assert ex.last_fault_stats == rex.last_fault_stats


# ------------------------------------------------- concurrency safety
def test_concurrent_stress_seeded_with_watchdog():
    """Many schedule shapes x repeated runs on one executor: results stay
    bitwise stable across reps and within the reference's tolerance of
    its result.  A faulthandler watchdog turns a deadlock into a
    traceback dump of every thread and a hard exit instead of a hang."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        rng = np.random.default_rng(20260808)
        ex = T.ScheduleExecutor(mode="concurrent", torch_device=CPU)
        for _ in range(6):
            M, N, K = (int(v) * 64 for v in rng.integers(2, 5, size=3))
            nstreams = int(rng.integers(1, 4))
            nbuf = int(rng.integers(1, 4))
            traversal = ["col", "row", "serpentine"][int(rng.integers(3))]
            A, B, C, sched, rsched = _gemm_case(
                rng, M=M, N=N, K=K, nstreams=nstreams, nbuf=nbuf,
                traversal=traversal)
            assert [op_key(o) for o in sched.ops] \
                == [op_key(o) for o in rsched.ops]
            stats = T.schedule_stats(sched)
            ref = None
            for _rep in range(3):
                out = {"C": torch.from_numpy(np.array(C, copy=True))}
                ex.run(sched, {"A": A, "B": B}, out,
                       {"alpha": 1.0, "beta": 0.5})
                assert ex.last_h2d_bytes == stats["h2d_bytes"]
                assert ex.last_d2h_bytes == stats["d2h_bytes"]
                _assert_linear_extension(sched, ex.last_completion_order)
                if ref is None:
                    ref = out["C"]
                else:
                    assert torch.equal(out["C"], ref), (
                        f"run-to-run divergence on {M}x{N}x{K} "
                        f"ns={nstreams} nbuf={nbuf} {traversal}")
            rout = np.array(C, copy=True)
            R.ScheduleExecutor(mode="concurrent").run(
                rsched, {"A": A, "B": B}, {"C": rout},
                {"alpha": 1.0, "beta": 0.5})
            np.testing.assert_allclose(ref.numpy(), rout, rtol=1e-4,
                                       atol=1e-4)
    finally:
        faulthandler.cancel_dump_traceback_later()


def test_metric_publishing_from_engine_threads_is_thread_safe():
    """The port's one-lock MetricRegistry survives concurrent publishes:
    raw increments hammered from worker threads, and whole executor runs
    racing each other, whose per-run aggregates must still sum."""
    from repro_torch.obs import get_observability

    obs = get_observability()
    obs.reset()
    obs.enable(metrics=True)
    try:
        reg = obs.metrics
        c = reg.counter("repro_test_engine_total", "stress counter")
        threads = [
            threading.Thread(
                target=lambda: [c.inc(kernel="stress")
                                for _ in range(500)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value(kernel="stress") == 8 * 500

        rng = np.random.default_rng(23)
        A, B, C, sched, _ = _gemm_case(rng, M=128, N=128, K=128, frac=2)
        stats = T.schedule_stats(sched)
        n_runs = 4
        errors = []

        def one_run():
            try:
                ex = T.ScheduleExecutor(mode="concurrent", torch_device=CPU)
                ex.run(sched, {"A": A, "B": B},
                       {"C": torch.from_numpy(np.array(C, copy=True))},
                       {"alpha": 1.0, "beta": 0.0})
            except BaseException as exc:   # surfaced below, not lost
                errors.append(exc)

        runners = [threading.Thread(target=one_run) for _ in range(n_runs)]
        for t in runners:
            t.start()
        for t in runners:
            t.join()
        assert not errors, errors
        kernel = sched.meta.get("kernel", "run")
        assert reg.get("repro_executor_runs_total").value(
            kernel=kernel) == n_runs
        assert reg.get("repro_executor_h2d_bytes").value(
            kernel=kernel) == n_runs * stats["h2d_bytes"]
    finally:
        obs.reset().disable()
