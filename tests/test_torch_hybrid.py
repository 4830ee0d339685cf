"""Hybrid co-execution in the port against the reference (CPU).

Twins of ``tests/test_hybrid.py``, on the same shapes and the canned
``gpu_profile()`` / ``phi_profile()`` pair: every member runs on the CPU
(``torch_device="cpu"``, one BLAS thread, so the port's plain path sums
each element in one order).

  * Balance shares and predictions, hybrid plans (per member, ``to_json()``)
    and ``simulate_hybrid`` makespans *equal* the reference's.
  * Hybrid GEMM and SYRK are bit for bit equal to the port's own
    single-device ``ooc_gemm`` / ``ooc_syrk``, and agree with the reference
    at its 1e-4 (the reference's SYRK is not bitwise against its own
    single-device run; the port's is).
  * Attention agrees with the reference's oracle at 1e-4 and
    ``merge_attention_partials`` with the reference's merge at 1e-6.
  * Lane groups, the facade, the factory and the registry; the launch
    counters under two members' threads.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.hybrid as RH
import repro_torch.core as T
import repro_torch.hybrid as TH
from repro.kernels import ref
from repro.tune import gpu_profile as r_gpu
from repro.tune import phi_profile as r_phi
from repro.tune import search_gemm as r_search_gemm
from repro_torch.core.api import (hclDeviceFactory, hclHybridRuntime,
                                  hclRuntimeFactory)
from repro_torch.core.runtime import _RUNTIME_REGISTRY
from repro_torch.tune import gpu_profile, phi_profile, search_gemm

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from tests._hypothesis_shim import given, settings, st

CPU = "cpu"
FAST = dict(nbuf_options=(1, 2), max_steps=256)


def _devices(budget, flops_ratio=1.0, mod=TH):
    gpu, phi = (gpu_profile, phi_profile) if mod is TH else (r_gpu, r_phi)
    return [mod.DeviceSpec("gpu0", gpu(), budget),
            mod.DeviceSpec("phi0", phi(flops=0.725e12 * flops_ratio),
                           budget)]


def _same_plan(tp, rp):
    """A port HybridPlan equals the reference's: problem, dtype, balance
    (shares, predictions, iterations, convergence) and each member's
    span and tuned plan."""
    assert (tp.kernel, tuple(tp.problem), tp.dtype) \
        == (rp.kernel, tuple(rp.problem), rp.dtype)
    tb, rb = tp.balance, rp.balance
    assert (tb.total, tb.shares, tb.predicted, tb.iterations, tb.converged) \
        == (rb.total, rb.shares, rb.predicted, rb.iterations, rb.converged)
    assert [(d.device.name, d.start, d.length, d.plan.to_json())
            for d in tp.device_plans] \
        == [(d.device.name, d.start, d.length, d.plan.to_json())
            for d in rp.device_plans]


def _rng():
    return np.random.default_rng(0)


# ----------------------------------------------------------- balancer props
@settings(max_examples=20, deadline=None)
@given(m=st.sampled_from([256, 520, 1024, 2048, 4096]),
       ratio=st.floats(min_value=0.05, max_value=1.0))
def test_shares_cover_problem_and_fit_budgets(m, ratio):
    N, K = 512, 256
    budget = (m * K + K * N + m * N) * 4 // 3
    hp = TH.plan_hybrid_gemm(m, N, K, _devices(budget, ratio), **FAST)
    _same_plan(hp, RH.plan_hybrid_gemm(
        m, N, K, _devices(budget, ratio, RH), **FAST))
    assert sum(hp.balance.shares) == m
    cursor = 0
    for dp in hp.device_plans:
        assert dp.start == cursor and dp.length > 0
        cursor += dp.length
    assert cursor == m
    for dp in hp.device_plans:
        part = dp.gemm_partition()
        assert (part.M, part.N, part.K) == (dp.length, N, K)
        fits = min(part.working_set_bytes(dp.plan.nbuf, dp.plan.nstreams),
                   part.working_set_bytes())
        assert fits <= dp.device.budget_bytes


def test_balance_units_equalizes_linear_costs():
    rates = (3.0, 1.0)
    res = TH.balance_units(4096, 2, lambda i, u: u / rates[i],
                           tolerance=0.01)
    assert res.converged and sum(res.shares) == 4096
    assert res.shares[0] == pytest.approx(3072, abs=64)
    assert res.spread <= 0.01
    want = RH.balance_units(4096, 2, lambda i, u: u / rates[i],
                            tolerance=0.01)
    assert (res.shares, res.predicted, res.iterations) \
        == (want.shares, want.predicted, want.iterations)


def test_dominant_profile_degenerates_to_single_device():
    M, N, K = 1024, 512, 256
    budget = (M * K + K * N + M * N) * 4 // 3
    hp = TH.plan_hybrid_gemm(M, N, K, _devices(budget, 1e-5), **FAST)
    _same_plan(hp, RH.plan_hybrid_gemm(M, N, K, _devices(budget, 1e-5, RH),
                                       **FAST))
    assert [dp.device.name for dp in hp.device_plans] == ["gpu0"]
    assert hp.device_plans[0].length == M
    assert hp.balance.spread == 0.0
    solo = search_gemm(M, N, K, budget, gpu_profile(), dtype="float32",
                       fingerprint="hybrid-gpu0", **FAST)
    assert hp.device_plans[0].plan == solo
    assert solo.to_json() == r_search_gemm(
        M, N, K, budget, r_gpu(), dtype="float32",
        fingerprint="hybrid-gpu0", **FAST).to_json()


def test_infeasible_device_is_dropped():
    M, N, K = 1024, 512, 256
    rich = (M * K + K * N + M * N) * 4 // 3
    devs = [TH.DeviceSpec("big", gpu_profile(), rich),
            TH.DeviceSpec("tiny", phi_profile(), 1024)]
    hp = TH.plan_hybrid_gemm(M, N, K, devs, **FAST)
    assert [dp.device.name for dp in hp.device_plans] == ["big"]
    _same_plan(hp, RH.plan_hybrid_gemm(
        M, N, K, [RH.DeviceSpec("big", r_gpu(), rich),
                  RH.DeviceSpec("tiny", r_phi(), 1024)], **FAST))
    with pytest.raises(ValueError, match="no feasible split"):
        TH.plan_hybrid_gemm(M, N, K,
                            [TH.DeviceSpec("tiny", phi_profile(), 1024)],
                            **FAST)


def test_unaligned_total_with_infeasible_device():
    M, N, K = 4100, 512, 256
    rich = (M * K + K * N + M * N) * 4 // 3
    devs = [TH.DeviceSpec("big", gpu_profile(), rich),
            TH.DeviceSpec("tiny", phi_profile(), 1024)]
    hp = TH.plan_hybrid_gemm(M, N, K, devs, **FAST)
    assert [dp.device.name for dp in hp.device_plans] == ["big"]
    assert hp.device_plans[0].length == M
    hp2 = TH.plan_hybrid_gemm(M, N, K, list(reversed(devs)), **FAST)
    assert [dp.device.name for dp in hp2.device_plans] == ["big"]
    assert sum(hp2.balance.shares) == M
    rdevs = [RH.DeviceSpec("big", r_gpu(), rich),
             RH.DeviceSpec("tiny", r_phi(), 1024)]
    _same_plan(hp2, RH.plan_hybrid_gemm(M, N, K, list(reversed(rdevs)),
                                        **FAST))


def test_balance_gemm_direct_oracle():
    M, N, K = 2048, 512, 256
    budget = (M * K + K * N + M * N) * 4 // 3
    res = TH.balance_gemm(M, N, K, _devices(budget), tolerance=0.10)
    assert sum(res.shares) == M and res.spread <= res.tolerance
    assert res.shares[0] > res.shares[1] > 0
    want = RH.balance_gemm(M, N, K, _devices(budget, mod=RH), tolerance=0.10)
    assert (res.shares, res.predicted, res.iterations, res.converged) \
        == (want.shares, want.predicted, want.iterations, want.converged)


# ------------------------------------------------------- execution exactness
def test_hybrid_gemm_bitwise_vs_single_device_and_oracle():
    rng = _rng()
    M, N, K = 512, 384, 256
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    hp = TH.plan_hybrid_gemm(M, N, K, _devices(budget), **FAST)
    assert len(hp.device_plans) == 2, "both profiles must take work"
    out, groups = TH.run_hybrid_gemm(A, B, C, 1.5, -0.5, hp, validate=True,
                                     torch_device=CPU)
    single = T.ooc_gemm(A, B, C, 1.5, -0.5, budget_bytes=budget,
                        torch_device=CPU)
    assert torch.equal(out, single)
    rhp = RH.plan_hybrid_gemm(M, N, K, _devices(budget, mod=RH), **FAST)
    _same_plan(hp, rhp)
    rout, _ = RH.run_hybrid_gemm(A, B, C, 1.5, -0.5, rhp)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)
    expect = np.asarray(ref.gemm_ref(jnp.asarray(A), jnp.asarray(B),
                                     jnp.asarray(C), 1.5, -0.5))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    assert [g[0] for g in groups] == ["gpu0", "phi0"]
    # summed executor bytes are the members' schedules' (exact)
    stats = TH.executor.last_run_stats()
    assert stats["h2d_bytes"] == stats["sched_h2d_bytes"] > 0
    assert stats["d2h_bytes"] == stats["sched_d2h_bytes"] == C.nbytes
    assert set(stats["device_walls"]) == {"gpu0", "phi0"}


def test_hybrid_syrk_bitwise_vs_single_device_and_oracle():
    rng = _rng()
    n, K = 512, 256
    P = rng.standard_normal((n, K)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    budget = (2 * n * K + n * n) * 4 // 3
    hp = TH.plan_hybrid_syrk(n, K, _devices(budget), **FAST)
    assert len(hp.device_plans) == 2
    out, _ = TH.run_hybrid_syrk(P, C, 2.0, 0.5, hp, validate=True,
                                torch_device=CPU)
    single = T.ooc_syrk(P, C, 2.0, 0.5, budget_bytes=budget,
                        torch_device=CPU)
    assert torch.equal(out, single)
    rhp = RH.plan_hybrid_syrk(n, K, _devices(budget, mod=RH), **FAST)
    _same_plan(hp, rhp)
    rout, _ = RH.run_hybrid_syrk(P, C, 2.0, 0.5, rhp)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)
    expect = np.asarray(ref.gemm_ref(jnp.asarray(P), jnp.asarray(P).T,
                                     jnp.asarray(C), 2.0, 0.5))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)


def _decode_ref(q, k, v):
    S = k.shape[0]
    return np.asarray(ref.decode_attention_ref(
        jnp.asarray(q)[None], jnp.asarray(k)[None], jnp.asarray(v)[None],
        jnp.asarray([S]))[0])


def test_hybrid_attention_matches_oracle():
    rng = _rng()
    S, hkv, d, H = 1024, 4, 64, 8
    q = rng.standard_normal((H, d)).astype(np.float32)
    k = rng.standard_normal((S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, hkv, d)).astype(np.float32)
    hp = TH.plan_hybrid_attention(S, hkv, d, H, _devices(k.nbytes // 2),
                                  dtype="float32")
    assert sum(hp.balance.shares) == S and len(hp.device_plans) == 2
    rhp = RH.plan_hybrid_attention(S, hkv, d, H,
                                   _devices(k.nbytes // 2, mod=RH),
                                   dtype="float32")
    _same_plan(hp, rhp)
    out, groups = TH.run_hybrid_attention(q, k, v, hp, validate=True,
                                          torch_device=CPU)
    assert out.dtype == torch.float32 and out.shape == (H, d)
    np.testing.assert_allclose(out.numpy(), _decode_ref(q, k, v),
                               rtol=1e-4, atol=1e-4)
    rout, _ = RH.run_hybrid_attention(q, k, v, rhp)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)
    assert [g[0] for g in groups] == ["gpu0", "phi0"]
    stats = TH.executor.last_run_stats()
    assert stats["h2d_bytes"] == stats["sched_h2d_bytes"] == 2 * k.nbytes
    assert stats["merge_seconds"] >= 0.0


def test_merge_attention_partials_is_exact():
    rng = _rng()
    H, d = 8, 16
    parts = []
    for _ in range(3):
        m = rng.standard_normal(H).astype(np.float32)
        l = rng.uniform(0.5, 2.0, H).astype(np.float32)
        acc = rng.standard_normal((H, d)).astype(np.float32)
        parts.append((m, l, acc))
    merged = TH.merge_attention_partials(parts)
    np.testing.assert_allclose(merged.numpy(),
                               RH.merge_attention_partials(parts),
                               rtol=1e-6, atol=1e-6)
    ab = TH.merge_attention_partials(parts[:2])
    m01 = np.maximum(parts[0][0], parts[1][0])
    l01 = (parts[0][1] * np.exp(parts[0][0] - m01)
           + parts[1][1] * np.exp(parts[1][0] - m01))
    acc01 = (parts[0][2] * np.exp(parts[0][0] - m01)[:, None]
             + parts[1][2] * np.exp(parts[1][0] - m01)[:, None])
    seq = TH.merge_attention_partials([(m01, l01, acc01), parts[2]])
    np.testing.assert_allclose(merged.numpy(), seq.numpy(), rtol=1e-6,
                               atol=1e-6)
    # numpy's and torch's float32 exp may differ in the last bit, and an
    # element summed near zero then misses a relative-only bound
    np.testing.assert_allclose(ab.numpy(), acc01 / l01[:, None], rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------- entry points/facade
def test_ooc_gemm_devices_entry_point():
    rng = _rng()
    M, N, K = 384, 256, 192
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + M * N * 4) // 3
    out = T.ooc_gemm(A, B, budget_bytes=1, torch_device=CPU,
                     devices=[("g", gpu_profile(), budget),
                              ("p", phi_profile(), budget)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.gemm_ref(
        jnp.asarray(A), jnp.asarray(B))), rtol=1e-4, atol=1e-4)
    rout = R.ooc_gemm(A, B, budget_bytes=1,
                      devices=[("g", r_gpu(), budget),
                               ("p", r_phi(), budget)])
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-4, atol=1e-4)


def test_ooc_attention_devices_entry_point():
    rng = _rng()
    S, hkv, d, H = 512, 2, 32, 4
    q = rng.standard_normal((H, d)).astype(np.float32)
    k = rng.standard_normal((S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, hkv, d)).astype(np.float32)
    out = T.ooc_attention(q, k, v, budget_bytes=1, torch_device=CPU,
                          devices=_devices(k.nbytes))
    assert out.dtype == torch.float32 and out.shape == (H, d)
    np.testing.assert_allclose(out.numpy(), _decode_ref(q, k, v),
                               rtol=1e-4, atol=1e-4)
    rout = R.ooc_attention(q, k, v, budget_bytes=1,
                           devices=_devices(k.nbytes, mod=RH))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-4,
                               atol=1e-4)


def test_hybrid_runtime_facade_and_factory():
    rng = _rng()
    M, N, K = 384, 256, 192
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = np.zeros((M, N), np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 3
    rt = hclHybridRuntime(_devices(budget), torch_device=CPU, **FAST)
    out = rt.gemm(A, B, C, 1.0, 0.0, record_spans=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.gemm_ref(
        jnp.asarray(A), jnp.asarray(B))), rtol=1e-4, atol=1e-4)
    assert rt.last_plan is not None and rt.last_span_groups
    assert all(spans for _, spans in rt.last_span_groups)
    _same_plan(rt.last_plan, RH.plan_hybrid_gemm(
        M, N, K, _devices(budget, mod=RH), **FAST))
    dev = T.Device("HYBRID", 0, 2 * budget)
    rt2 = hclRuntimeFactory.create(dev, devices=_devices(budget),
                                   torch_device=CPU)
    assert isinstance(rt2, TH.HybridOocRuntime)
    assert rt2.torch_device == torch.device("cpu")
    rt3 = hclRuntimeFactory.create(hclDeviceFactory.create("HYBRID"),
                                   devices=_devices(budget),
                                   torch_device=CPU)
    assert rt3.mem_size() == 2 * budget
    with pytest.raises(ValueError, match="needs devices"):
        T.RuntimeFactory.create(T.Device("HYBRID", 0, 0))


# ------------------------------------------------- prediction + lane groups
def test_simulate_hybrid_beats_best_single_device():
    M = N = K = 8192
    budget = (M * K + K * N + M * N) * 8 // 6
    opts = dict(nbuf_options=(1, 2), max_steps=128)
    hp = TH.plan_hybrid_gemm(M, N, K, _devices(budget), dtype="float64",
                             tolerance=0.05, **opts)
    rhp = RH.plan_hybrid_gemm(M, N, K, _devices(budget, mod=RH),
                              dtype="float64", tolerance=0.05, **opts)
    _same_plan(hp, rhp)
    sim = TH.simulate_hybrid(hp)
    assert sim.makespan == RH.simulate_hybrid(rhp).makespan
    assert sim.device_makespans == RH.simulate_hybrid(rhp).device_makespans
    best = min(search_gemm(M, N, K, d.budget_bytes, d.profile,
                           dtype="float64", fingerprint="x",
                           **opts).makespan
               for d in _devices(budget))
    assert sim.makespan < best
    assert hp.balance.spread <= hp.tolerance
    for dp, got in zip(hp.device_plans, sim.device_makespans):
        assert got == pytest.approx(dp.plan.makespan, rel=1e-12)


def test_trace_lane_group_per_device_no_collisions():
    M, N, K = 1024, 512, 256
    budget = (M * K + K * N + M * N) * 4 // 3
    hp = TH.plan_hybrid_gemm(M, N, K, _devices(budget), **FAST)
    trace = TH.simulate_hybrid(hp).to_chrome_trace()
    rhp = RH.plan_hybrid_gemm(M, N, K, _devices(budget, mod=RH), **FAST)
    assert trace == RH.simulate_hybrid(rhp).to_chrome_trace()
    events = trace["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in events
             if e["name"] == "process_name"}
    assert names == {0: "gpu0", 1: "phi0"}
    xs = [e for e in events if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {0, 1}
    slots = [(e["pid"], e["tid"], e["ts"]) for e in xs]
    assert len(slots) == len(set(slots))
    per_dev = TH.simulate_hybrid(hp).per_device
    for pid, (_, res) in enumerate(per_dev):
        assert sum(e["pid"] == pid for e in xs) == len(res.op_spans)


def test_chrome_trace_groups_standalone():
    groups = [("devA", [("DGEMM[0]", 0, 0.0, 1.0)]),
              ("devB", [("DGEMM[0]", 0, 0.5, 1.5)])]
    trace = T.chrome_trace_groups(groups)
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [(e["pid"], e["tid"]) for e in xs] == [(0, 0), (1, 0)]
    assert trace == R.chrome_trace_groups(groups)


# ------------------------------------------------------------ registry unit
def test_register_runtime_plugs_in_new_tier():
    @T.register_runtime("TESTTIER")
    class TestTierRuntime(T.HostOocRuntime):
        pass

    try:
        rt = T.RuntimeFactory.create(T.Device("TESTTIER", 0, 1 << 20),
                                     torch_device=CPU)
        assert isinstance(rt, TestTierRuntime)
        assert "TESTTIER" in T.RuntimeFactory.registered()
    finally:
        _RUNTIME_REGISTRY.pop("TESTTIER", None)


def test_factory_rejects_unknown_tier():
    with pytest.raises(ValueError, match="registered tiers"):
        T.RuntimeFactory.create(T.Device("NOPE", 0, 1))
    for tier in ("HBM", "VMEM", "HYBRID"):
        assert tier in T.RuntimeFactory.registered()
    # the MESH tier (ROADMAP module item 10) is registered and needs a mesh
    assert "MESH" in T.RuntimeFactory.registered()
    with pytest.raises(ValueError, match="DeviceMesh"):
        T.RuntimeFactory.create(T.Device("MESH", 0, 1 << 20))


# ------------------------------------------------- port-side: what it adds
def test_hybrid_analysis_is_ported():
    """``HybridAnalysis`` and ``analyze_hybrid`` live in the executor
    module, outside the package's ``__all__``, as in the reference, and
    attribute a plan as the reference does (``tests/test_torch_analyze.py``
    holds the documents equal on the reference tests' pair)."""
    import repro.hybrid.executor as RE
    import repro_torch.hybrid.executor as E

    assert TH.__all__ == RH.__all__
    for name in ("HybridAnalysis", "analyze_hybrid"):
        assert callable(getattr(E, name)) and callable(getattr(RE, name))
        assert name not in TH.__all__
    m = 512
    budget = (3 * m * m * 4) // 2
    tp = TH.plan_hybrid_gemm(m, m, m, _devices(budget), dtype="float32",
                             **FAST)
    rp = RH.plan_hybrid_gemm(m, m, m, _devices(budget, mod=RH),
                             dtype="float32", **FAST)
    _same_plan(tp, rp)
    ta, ra = E.analyze_hybrid(tp), RE.analyze_hybrid(rp)
    assert isinstance(ta, E.HybridAnalysis)
    assert ta.to_json() == ra.to_json()


def test_launch_counts_exact_under_two_member_threads(monkeypatch):
    """Two members' executors issue from two pool threads; a launch count
    taken through ``count_launch`` (as the kernel wrappers take theirs)
    loses no increment.  On the CPU the wrappers run their plain versions
    and count nothing, so a shim around the plain GEMM counts here."""
    from repro_torch.core import runtime as T_runtime
    from repro_torch.kernels import count_launch

    def counter():
        pass

    counter.launches, counter.launches_by_dtype = 0, {}
    plain = T_runtime.kops.block_matmul

    def counted(*a, **kw):
        count_launch(counter, "float32")
        return plain(*a, **kw)

    monkeypatch.setattr(T_runtime.kops, "block_matmul", counted)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)    # thread switches as often as possible
    try:
        rng = _rng()
        M, N, K = 512, 384, 256
        A = rng.standard_normal((M, K)).astype(np.float32)
        B = rng.standard_normal((K, N)).astype(np.float32)
        budget = (A.nbytes + B.nbytes + M * N * 4) // 8
        hp = TH.plan_hybrid_gemm(M, N, K, _devices(budget), **FAST)
        assert len(hp.device_plans) == 2
        ops = sum(
            1 for dp in hp.device_plans
            for op in TH.device_schedule(hp, dp).ops
            if op.kind == T.OpKind.COMPUTE and op.payload.kernel == "dgemm")
        for _ in range(3):
            counter.launches, counter.launches_by_dtype = 0, {}
            out, _ = TH.run_hybrid_gemm(A, B, None, 1.0, 0.0, hp,
                                        torch_device=CPU)
            assert counter.launches == ops
            assert counter.launches_by_dtype == {"float32": ops}
        np.testing.assert_allclose(out.numpy(), A @ B, rtol=1e-4, atol=1e-4)

        # and the counter itself, from eight threads at once
        counter.launches, counter.launches_by_dtype = 0, {}

        def hammer():
            for _ in range(5000):
                count_launch(counter, "bfloat16")

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert counter.launches == 40000
        assert counter.launches_by_dtype == {"bfloat16": 40000}
    finally:
        sys.setswitchinterval(switch)


def test_member_executor_kept_across_calls():
    """Each member's executor (and on a card its streams) is kept across
    calls, keyed by member name and torch device."""
    from repro_torch.hybrid.executor import _member

    rng = _rng()
    M, N, K = 256, 128, 64
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + M * N * 4) // 3
    hp = TH.plan_hybrid_gemm(M, N, K, _devices(budget), **FAST)
    first, _ = TH.run_hybrid_gemm(A, B, None, 1.0, 0.0, hp,
                                  torch_device=CPU)
    exs = [_member(dp.device.name, torch.device("cpu")).executor
           for dp in hp.device_plans]
    again, _ = TH.run_hybrid_gemm(A, B, None, 1.0, 0.0, hp,
                                  torch_device=CPU)
    assert [_member(dp.device.name, torch.device("cpu")).executor
            for dp in hp.device_plans] == exs
    assert all(ex.mode == "concurrent" for ex in exs)
    assert [ex.trace_group for ex in exs] == ["gpu0", "phi0"]
    assert torch.equal(first, again)


def test_hybrid_bf16_and_float64_operands():
    """The reference's host dtypes: float64 is computed in float32 and
    returned as float64; an ml_dtypes bfloat16 array is planned as
    ``bfloat16`` (plans equal the reference's) and computed in bf16."""
    import ml_dtypes

    rng = _rng()
    M, N, K = 256, 128, 64
    A = rng.standard_normal((M, K))
    B = rng.standard_normal((K, N))
    budget = (A.nbytes + B.nbytes + M * N * 8) // 3
    out = T.ooc_gemm(A, B, budget_bytes=1, torch_device=CPU,
                     devices=_devices(budget))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), A @ B, rtol=1e-4, atol=1e-4)
    Ab, Bb = A.astype(ml_dtypes.bfloat16), B.astype(ml_dtypes.bfloat16)
    bbudget = budget // 4
    hp = TH.plan_hybrid_gemm(M, N, K, _devices(bbudget), dtype=torch.bfloat16,
                             **FAST)
    _same_plan(hp, RH.plan_hybrid_gemm(M, N, K, _devices(bbudget, mod=RH),
                                       dtype=ml_dtypes.bfloat16, **FAST))
    outb, _ = TH.run_hybrid_gemm(Ab, Bb, None, 1.0, 0.0, hp,
                                 torch_device=CPU)
    assert outb.dtype == torch.bfloat16
    single = T.ooc_gemm(Ab, Bb, budget_bytes=bbudget, torch_device=CPU)
    exact = Ab.astype(np.float32) @ Bb.astype(np.float32)
    np.testing.assert_allclose(outb.float().numpy(), exact, rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(outb.float().numpy(), single.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_hybrid_run_conformance_and_single_trace():
    """Twin of ``tests/test_obs.py::test_hybrid_run_conformance_and_single_
    trace``: one drift record per hybrid run with the reference's
    prediction and byte ratios of exactly 1.0, and one trace document with
    a lane group per member."""
    from repro.obs import get_observability as R_obs
    from repro_torch.obs import get_observability

    obs, robs = get_observability(), R_obs()
    for o in (obs, robs):
        o.reset().disable()
        o.enable(metrics=True, trace=True, trace_name="acceptance")
    try:
        rng = _rng()
        m, n, k = 512, 256, 128
        A = rng.standard_normal((m, k)).astype(np.float32)
        B = rng.standard_normal((k, n)).astype(np.float32)
        budget = (A.nbytes + B.nbytes + m * n * 4) // 3
        out = T.ooc_gemm(A, B, budget_bytes=budget, tune="auto",
                         devices=_devices(budget), tolerance=0.1,
                         torch_device=CPU)
        assert np.abs(out.numpy() - A @ B).max() < 1e-2
        R.ooc_gemm(A, B, budget_bytes=budget, tune="auto",
                   devices=_devices(budget, mod=RH), tolerance=0.1)
        recs = [r for r in obs.drift.records("gemm") if r.tier == "HYBRID"]
        (rrec,) = [r for r in robs.drift.records("gemm")
                   if r.tier == "HYBRID"]
        assert len(recs) == 1
        assert recs[0].byte_ratio == 1.0
        assert recs[0].predicted_d2h_bytes == recs[0].measured_d2h_bytes
        assert recs[0].fingerprint == "gpu0+phi0"
        assert recs[0].predicted_makespan == rrec.predicted_makespan > 0
        assert (recs[0].predicted_h2d_bytes, recs[0].predicted_d2h_bytes) \
            == (rrec.predicted_h2d_bytes, rrec.predicted_d2h_bytes)
        doc = obs.tracer.to_chrome_trace()
        lanes = {e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
        assert {"acceptance", "gpu0", "phi0"} <= lanes
        cats = {e.get("cat") for e in doc["traceEvents"]
                if e.get("ph") == "X"}
        assert "tune" in cats and "merge" in cats
        assert obs.metrics.get("repro_hybrid_runs_total").value(
            kernel="gemm") == 1
    finally:
        for o in (obs, robs):
            o.reset().disable()


def test_prefer_cusolver_nests_across_member_threads(monkeypatch):
    """Two members' runs enter ``prefer_cusolver`` from two threads and
    leave in the other order: the library stays cuSOLVER while either is
    inside and is set back to the caller's once both have left (a plain
    save-and-restore would leave cuSOLVER set)."""
    from repro_torch.core.runtime import prefer_cusolver

    state = {"lib": "default"}

    def preferred(backend=None):
        if backend is not None:
            state["lib"] = backend
        return state["lib"]

    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library",
                        preferred)
    card = torch.device("cuda", 0)
    entered = [threading.Event(), threading.Event()]
    leave = [threading.Event(), threading.Event()]
    seen = []

    def member(i):
        with prefer_cusolver(card):
            entered[i].set()
            leave[i].wait(10)
            seen.append(state["lib"])

    threads = [threading.Thread(target=member, args=(i,)) for i in (0, 1)]
    for t, e in zip(threads, entered):
        t.start()
        e.wait(10)
    leave[0].set()             # the first in leaves first
    threads[0].join(10)
    assert state["lib"] == "cusolver"
    leave[1].set()
    threads[1].join(10)
    assert seen == ["cusolver", "cusolver"]
    assert state["lib"] == "default"
    with prefer_cusolver(torch.device("cpu")):
        assert state["lib"] == "default"
