"""MMOOC end to end: the port's ``ooc_gemm``/``ooc_syrk`` against the
reference's, on the CPU (plain kernel versions), on the shapes of
``test_oocgemm.py`` — plus the bit-for-bit invariants the kernel's fixed
K order gives the port: the out-of-core result equals the in-core one for
every traversal and eviction policy, and the vmem backend agrees too.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.kernels import ref as R_ref
from repro_torch.core.api import (hclCompileExecutable, hclCompilePipeline,
                                  hclDeviceFactory, hclGetMemSize,
                                  hclMatrixPartitioner, hclObservability,
                                  hclRuntimeFactory, hclStreamFactory)
from repro_torch.obs import get_observability

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _problem(seed, M, N, K, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(dtype),
            rng.standard_normal((K, N)).astype(dtype),
            rng.standard_normal((M, N)).astype(dtype))


@pytest.mark.parametrize("M,N,K,frac", [
    (256, 256, 128, 4),
    (512, 384, 256, 8),
    (640, 128, 128, 3),
    (128, 128, 64, 1),     # in-core path
])
def test_ooc_gemm_host_matches_reference(M, N, K, frac):
    A, B, C = _problem(M + N + K, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    ref_out = R.ooc_gemm(A, B, C, 1.5, 0.25, budget_bytes=budget,
                         backend="host", validate=True)
    out = T.ooc_gemm(A, B, C, 1.5, 0.25, budget_bytes=budget,
                     backend="host", validate=True, torch_device=CPU)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    expect = 1.5 * (A.astype(np.float64) @ B) + 0.25 * C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("frac", [2, 5])
@pytest.mark.parametrize("nbuf", [1, 2, 3])
@pytest.mark.parametrize("nstreams", [1, 2])
def test_ooc_gemm_any_pipeline_config(nstreams, nbuf, frac):
    """The result is invariant to the pipeline configuration, and equals
    the reference's for the same configuration."""
    A, B, C = _problem(7, 320, 192, 128)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    kw = dict(budget_bytes=budget, backend="host", nstreams=nstreams,
              nbuf=nbuf, validate=True)
    out = T.ooc_gemm(A, B, C, 2.0, -0.5, torch_device=CPU, **kw)
    expect = 2.0 * (A.astype(np.float64) @ B) - 0.5 * C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(),
                               R.ooc_gemm(A, B, C, 2.0, -0.5, **kw),
                               rtol=1e-4, atol=1e-4)


def test_ooc_gemm_vmem_backend():
    A, B, C = _problem(3, 256, 256, 256)
    ref_out = R.ooc_gemm(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                         1.0, 1.0, budget_bytes=A.nbytes, backend="vmem")
    out = T.ooc_gemm(torch.from_numpy(A), torch.from_numpy(B),
                     torch.from_numpy(C), 1.0, 1.0, budget_bytes=A.nbytes,
                     backend="vmem", torch_device=CPU)
    expect = A.astype(np.float64) @ B + C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4,
                               atol=1e-4)


def test_in_core_switch():
    for args in ((64, 64, 64, 1 << 20, 4), (1024, 1024, 1024, 1 << 20, 4)):
        assert T.is_in_core(*args) == R.is_in_core(*args)
    assert T.is_in_core(64, 64, 64, 1 << 20, 4)


def test_hcl_facade():
    A, B, C = _problem(5, 512, 256, 128)
    dev = hclDeviceFactory.create("HBM", 0, mem_bytes=300_000)
    assert hclGetMemSize(dev) == 300_000
    rt = hclRuntimeFactory.create(dev, torch_device=CPU)
    assert isinstance(rt, T.HostOocRuntime)
    part = hclMatrixPartitioner(512, 256, 128, dev.mem_bytes)
    assert part == T.from_reference(
        R.plan_gemm_partition(512, 256, 128, dev.mem_bytes))
    out = rt.gemm(A, B, C, 1.0, 0.0, part)
    np.testing.assert_allclose(out.numpy(), A @ B, rtol=1e-4, atol=1e-4)
    vrt = hclRuntimeFactory.create(
        hclDeviceFactory.create("VMEM", 0, mem_bytes=1 << 20),
        torch_device=CPU)
    assert isinstance(vrt, T.VmemOocRuntime)
    assert T.plan_for_device(512, 256, 128, dev) == part
    streams = hclStreamFactory.create(dev, 2)
    assert [s.index for s in streams] == [0, 1]
    sched = hclCompilePipeline(T.gemm_pipeline_spec(part), nstreams=2,
                               nbuf=2)
    assert sched == T.build_gemm_schedule(part)
    assert hclCompileExecutable(sched) is T.compile_executable(sched)
    assert hclObservability() is get_observability()


@pytest.mark.parametrize("backend", ["host", "vmem"])
def test_ooc_syrk_matches_reference(backend):
    rng = np.random.default_rng(11)
    n, k = 384, 192
    P = rng.standard_normal((n, k)).astype(np.float32)
    C = rng.standard_normal((n, n)).astype(np.float32)
    budget = (2 * P.nbytes + C.nbytes) // 4   # force out-of-core
    ref_out = R.ooc_syrk(P, C, -2.0, 0.5, budget_bytes=budget,
                         backend=backend, validate=(backend == "host"))
    out = T.ooc_syrk(P, C, -2.0, 0.5, budget_bytes=budget, backend=backend,
                     validate=(backend == "host"), torch_device=CPU)
    expect = np.asarray(R_ref.gemm_ref(jnp.asarray(P), jnp.asarray(P).T,
                                       jnp.asarray(C), alpha=-2.0, beta=0.5))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4,
                               atol=1e-4)


def test_ooc_syrk_in_core_switch():
    rng = np.random.default_rng(12)
    P = rng.standard_normal((128, 64)).astype(np.float32)
    out = T.ooc_syrk(P, budget_bytes=1 << 30, backend="host",
                     torch_device=CPU)
    np.testing.assert_allclose(out.numpy(), P @ P.T, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        out.numpy(), R.ooc_syrk(P, budget_bytes=1 << 30, backend="host"),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("evict", ["lru", "belady"])
@pytest.mark.parametrize("traversal", list(T.TRAVERSALS))
def test_out_of_core_equals_in_core_bitwise(traversal, evict):
    """Bit for bit on the plain path: see ``one_torch_thread``."""
    A, B, C = _problem(41, 448, 320, 96)
    full = A.nbytes + B.nbytes + C.nbytes
    incore = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full,
                        torch_device=CPU)
    for nstreams, nbuf in ((1, 1), (2, 2), (2, 3)):
        out = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full // 4,
                         nstreams=nstreams, nbuf=nbuf, traversal=traversal,
                         evict=evict, torch_device=CPU)
        assert torch.equal(out, incore), (nstreams, nbuf)
    vmem = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=full // 4,
                      backend="vmem", torch_device=CPU)
    assert torch.equal(vmem, incore)
    _, _, Cs = _problem(42, 448, 448, 1)
    syrk_in = T.ooc_syrk(A, Cs, 1.0, 0.5, budget_bytes=1 << 30,
                         torch_device=CPU)
    syrk_ooc = T.ooc_syrk(A, Cs, 1.0, 0.5,
                          budget_bytes=(2 * A.nbytes + Cs.nbytes) // 4,
                          traversal=traversal, evict=evict,
                          torch_device=CPU)
    assert torch.equal(syrk_ooc, syrk_in)


def test_float64_operands_follow_the_reference():
    A, B, C = _problem(51, 320, 192, 128, dtype=np.float64)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    ref_out = R.ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget)
    out = T.ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget,
                     torch_device=CPU)
    assert out.dtype == torch.float64 and ref_out.dtype == np.float64
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,item", [
    (dict(backend="mesh"), "item 10"),
], ids=["kw2-item 10"])                 # the id this case always had
def test_paths_outside_the_slice_raise(kw, item):
    """The mesh backend (ROADMAP ``item``) needs its mesh: ``ooc_gemm``
    without ``mesh=`` or ``runtime=`` raises, and ``ooc_syrk`` has no mesh
    path (nor has the reference's)."""
    A, B, C = _problem(61, 64, 64, 64)
    with pytest.raises(ValueError, match="needs mesh="):
        T.ooc_gemm(A, B, C, budget_bytes=1 << 12, torch_device=CPU, **kw)
    with pytest.raises(ValueError, match="unknown backend 'mesh'"):
        T.ooc_syrk(A, budget_bytes=1 << 12, torch_device=CPU, **kw)


@pytest.mark.parametrize("tier,item", [("MESH", "item 10")])
def test_tiers_outside_the_slice_raise(tier, item):
    """The MESH tier (ROADMAP ``item``) is registered: the factory makes
    its runtime over a given DeviceMesh and raises without one; the hcl
    device factory makes its tier tuple."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    assert tier in T.RuntimeFactory.registered()
    with pytest.raises(ValueError, match="DeviceMesh"):
        T.RuntimeFactory.create(T.Device(tier, 0, 1 << 20))
    assert hclDeviceFactory.create(tier, 0, mem_bytes=1 << 20) \
        == T.Device(tier, 0, 1 << 20)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        rt = T.RuntimeFactory.create(T.Device(tier, 0, 1 << 20), mesh=mesh)
        assert isinstance(rt, T.MeshOocRuntime) and rt.mem_size() == 1 << 20
        A, B, C = _problem(62, 32, 24, 16)
        out = rt.gemm(A, B, C, 1.5, 0.5)
        ref = R.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=1 << 30)
        np.testing.assert_allclose(out.full_tensor().numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


# 16-bit host operands as the reference's callers hold them: ml_dtypes
# bfloat16 (which torch cannot read) and numpy float16.  Ragged shapes
# under budgets that force at least 2x2 blocks; the reference's 2e-2
# (tests/test_kernels.py).
HALF_DTYPES = [ml_dtypes.bfloat16, np.float16]
HALF_TOL = 2e-2


def _half_close(out: torch.Tensor, ref, dtype) -> None:
    want = {ml_dtypes.bfloat16: torch.bfloat16, np.float16: torch.float16}
    assert isinstance(out, torch.Tensor) and out.dtype == want[dtype]
    ref = np.asarray(ref)
    assert ref.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                               rtol=HALF_TOL, atol=HALF_TOL)


@pytest.mark.parametrize("backend", ["host", "vmem"])
@pytest.mark.parametrize("M,N,K,frac", [(192, 256, 160, 4),
                                        (200, 136, 72, 4),
                                        (130, 300, 45, 3)])
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
def test_ooc_gemm_half_host_operands_match_reference(dtype, M, N, K, frac,
                                                     backend):
    A, B, C = _problem(M + K, M, N, K, dtype=dtype)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    part = T.plan_gemm_partition(M, N, K, budget, A.itemsize)
    assert part.h >= 2 and part.w >= 2
    ref = R.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget,
                     backend=backend)
    out = T.ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget,
                     backend=backend, torch_device=CPU)
    _half_close(out, ref, dtype)


@pytest.mark.parametrize("backend", ["host", "vmem"])
@pytest.mark.parametrize("n,K,frac", [(200, 72, 4), (300, 64, 3)])
@pytest.mark.parametrize("dtype", HALF_DTYPES, ids=["bf16", "f16"])
def test_ooc_syrk_half_host_operands_match_reference(dtype, n, K, frac,
                                                     backend):
    rng = np.random.default_rng(n + K)
    P = rng.standard_normal((n, K)).astype(dtype)
    C = rng.standard_normal((n, n)).astype(dtype)
    budget = (2 * P.nbytes + C.nbytes) // frac
    part = T.plan_gemm_partition(n, n, K, budget, P.itemsize)
    assert part.h >= 2 and part.w >= 2
    ref = R.ooc_syrk(P, C, -1.0, 0.5, budget_bytes=budget, backend=backend)
    out = T.ooc_syrk(P, C, -1.0, 0.5, budget_bytes=budget, backend=backend,
                     torch_device=CPU)
    _half_close(out, ref, dtype)


@pytest.mark.parametrize("entry", ["host_tensor", "device_tensor",
                                   "executor_output", "hcl_runtime"])
def test_bf16_host_arrays_enter_the_port(entry):
    """An ml_dtypes bfloat16 array enters every host entry point without a
    TypeError, as an exact ``torch.bfloat16`` copy; an executor output of
    that type gets its result copied back."""
    A, B, C = _problem(5, 192, 256, 160, dtype=ml_dtypes.bfloat16)
    if entry in ("host_tensor", "device_tensor"):
        conv = getattr(T.runtime, entry)
        t = conv(A) if entry == "host_tensor" else conv(A, torch.device(CPU))
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.float().numpy(),
                                      A.astype(np.float32))
        return
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    part = T.plan_gemm_partition(192, 256, 160, budget, 2)
    want = T.ooc_gemm(torch.from_numpy(A.astype(np.float32)).bfloat16(),
                      torch.from_numpy(B.astype(np.float32)).bfloat16(),
                      torch.from_numpy(C.astype(np.float32)).bfloat16(),
                      1.5, 0.5, budget_bytes=budget, torch_device=CPU)
    if entry == "executor_output":
        out = C.copy()
        T.ScheduleExecutor(torch_device=CPU).run(
            T.build_gemm_schedule(part), {"A": A, "B": B}, {"C": out},
            {"alpha": 1.5, "beta": 0.5})
        got = torch.from_numpy(out.astype(np.float32)).bfloat16()
    else:
        rt = hclRuntimeFactory.create(hclDeviceFactory.create("HBM", 0,
                                                              budget),
                                      torch_device=CPU)
        got = rt.gemm(A, B, C, 1.5, 0.5, part)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# Integer and mixed-dtype operands, as the reference takes them: its block
# GEMM is a float32 dot cast to C's dtype, and C defaults to zeros of A's
# dtype.  400x200 @ 200x300 under 300,000 B is out of core on the host and
# vmem backends; a 1 GiB budget takes the in-core path.
MIXED_PATHS = {"host": dict(budget_bytes=300_000, backend="host"),
               "vmem": dict(budget_bytes=300_000, backend="vmem"),
               "in_core": dict(budget_bytes=1 << 30, backend="host")}


@pytest.mark.parametrize("path", list(MIXED_PATHS))
def test_integer_operands_are_exact(path):
    rng = np.random.default_rng(71)
    A = rng.integers(0, 5, (400, 200)).astype(np.int32)
    B = rng.integers(0, 5, (200, 300)).astype(np.int32)
    kw = MIXED_PATHS[path]
    assert T.is_in_core(400, 300, 200, kw["budget_bytes"], 4) \
        == (path == "in_core")
    ref = np.asarray(R.ooc_gemm(A, B, **kw))
    out = T.ooc_gemm(A, B, torch_device=CPU, **kw)
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), A.astype(np.int64) @ B)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("path", list(MIXED_PATHS))
def test_integer_syrk_is_exact(path):
    rng = np.random.default_rng(73)
    P = rng.integers(0, 5, (300, 100)).astype(np.int32)
    kw = dict(MIXED_PATHS[path])
    if path != "in_core":
        kw["budget_bytes"] = 200_000
    ref = np.asarray(R.ooc_syrk(P, **kw))
    out = T.ooc_syrk(P, torch_device=CPU, **kw)
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), P.astype(np.int64) @ P.T)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("path", list(MIXED_PATHS))
def test_half_times_float_returns_half(path):
    """An f16 A with an f32 B is computed in float32 and returned in f16
    (C's default dtype, A's), within the reference's 16-bit tolerance."""
    rng = np.random.default_rng(72)
    A = rng.standard_normal((400, 200)).astype(np.float16)
    B = rng.standard_normal((200, 300)).astype(np.float32)
    kw = MIXED_PATHS[path]
    ref = np.asarray(R.ooc_gemm(A, B, **kw))
    out = T.ooc_gemm(A, B, torch_device=CPU, **kw)
    assert out.dtype == torch.float16 and ref.dtype == np.float16
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                               rtol=HALF_TOL, atol=HALF_TOL)
    exact = A.astype(np.float64) @ B
    np.testing.assert_allclose(out.float().numpy(), exact, rtol=HALF_TOL,
                               atol=HALF_TOL)


# ----------------------------------------- the host backend's output buffer
def _host_call(entry, C=None, alpha=1.0, beta=0.0, ex=None, **kw):
    """``ooc_gemm``/``ooc_syrk`` out of core on the host backend (CPU), on
    ``ex`` when given."""
    A, B, _ = _problem(21, 256, 256, 128)
    budget = (A.nbytes + B.nbytes + 256 * 256 * 4) // 4
    if ex is not None:
        kw["runtime"] = T.HostOocRuntime(T.Device("HBM", 0, budget),
                                         executor=ex)
    else:
        kw["torch_device"] = CPU
    if entry == "gemm":
        return T.ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget, **kw)
    return T.ooc_syrk(A, C, alpha, beta, budget_bytes=budget, **kw)


@pytest.mark.parametrize("entry", ["gemm", "syrk"])
def test_host_call_without_c_runs_into_its_own_zeros(entry):
    """With no C the call returns an output of its own, never copied (no
    ``.clone_c``), bit for bit the call with explicit zeros at β = 0.  The
    GEMM's C blocks start as zeros made on the device (no ``.zero_c``, no
    copy, its fill bytes counted); the SYRK runs into host zeros
    (``.zero_c``)."""
    want = _host_call(entry, np.zeros((256, 256), np.float32))
    ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
    got = _host_call(entry, ex=ex)
    assert torch.equal(got, want)
    rec = get_observability().calls[-1]
    spans = set(rec.seconds)
    assert f"{entry}.execute" in spans
    assert f"{entry}.clone_c" not in spans
    on_card = entry == "gemm"
    assert (f"{entry}.zero_c" in spans) == (not on_card)
    assert rec.copy_bytes == (0 if on_card else got.numel() * 4)
    assert rec.fill_bytes == ex.last_fill_bytes \
        == (got.numel() * 4 if on_card else 0)


@pytest.mark.parametrize("C_type", ["numpy", "tensor"])
@pytest.mark.parametrize("entry", ["gemm", "syrk"])
def test_host_call_never_writes_the_callers_c(entry, C_type):
    """A caller's C at β ≠ 0 is copied (``.clone_c``): it reads the same
    after the call, and the result shares no storage with it."""
    C = np.random.default_rng(22).standard_normal(
        (256, 256)).astype(np.float32)
    if C_type == "tensor":
        C = torch.from_numpy(C)
    before = np.array(C, copy=True)
    ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
    out = _host_call(entry, C, 1.5, 0.5, ex=ex)
    np.testing.assert_array_equal(np.asarray(C), before)
    assert (out.untyped_storage().data_ptr()
            != torch.as_tensor(C).untyped_storage().data_ptr())
    rec = get_observability().calls[-1]
    assert f"{entry}.clone_c" in rec.seconds
    assert f"{entry}.zero_c" not in rec.seconds
    A, B, _ = _problem(21, 256, 256, 128)
    A = A.astype(np.float64)
    B = B if entry == "gemm" else A.T
    np.testing.assert_allclose(out.numpy(), 1.5 * (A @ B) + 0.5 * before,
                               rtol=1e-4, atol=1e-4)


def test_oom_ladder_without_c_returns_the_clean_bits():
    """An injected oom with no C walks the degrade ladder; the re-run starts
    from zeros of its own and returns the clean run's bits."""
    from repro_torch.fault import FaultPlan, FaultPolicy, FaultSpec

    def oom_at_first_compute(sched):
        i = next(i for i, op in enumerate(sched.ops)
                 if op.kind.name == "COMPUTE")
        return FaultPlan(specs=(FaultSpec(op=i, cls="oom"),))

    clean = _host_call("gemm")
    pol = FaultPolicy(sleep=lambda s: None)
    out = _host_call("gemm", faults=oom_at_first_compute, fault_policy=pol)
    assert [d.action for d in pol.degrades] == ["halve_nbuf"]
    assert torch.equal(out, clean)


# ------------------------------------ a β = 0 C made on the device (fill_c)
def test_gemm_without_c_makes_c_on_the_device():
    """An out-of-core no-C host GEMM over ragged edge blocks: the schedule
    fills C's blocks on the device, the output is bit for bit the
    reference-equal path (S(c_ij) copies of host zeros), the H2D bytes are
    ``schedule_stats``' and M·N·4 below that path's, and the fill bytes,
    M·N·4, reach the call record and ``repro_executor_fill_bytes``."""
    M, N, K = 300, 260, 96
    A, B, _ = _problem(81, M, N, K)
    budget = (A.nbytes + B.nbytes + M * N * 4) // 4
    part = T.plan_gemm_partition(M, N, K, budget, 4)
    assert M % part.bm and N % part.bn and part.h > 1 and part.w > 1
    ref_ex = T.ScheduleExecutor(torch_device=CPU)
    want = torch.zeros(M, N)
    ref_sched = T.build_gemm_schedule(part)
    ref_ex.run(ref_sched, {"A": A, "B": B}, {"C": want},
               {"alpha": 1.0, "beta": 0.0})
    obs = get_observability()
    obs.reset().enable(metrics=True)
    try:
        ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
        got = T.ooc_gemm(A, B, budget_bytes=budget,
                         runtime=T.HostOocRuntime(T.Device("HBM", 0, budget),
                                                  executor=ex))
        assert torch.equal(got, want)
        stats = T.schedule_stats(T.build_gemm_schedule(part, fill_c=True))
        assert ex.last_h2d_bytes == stats["h2d_bytes"] \
            == ref_ex.last_h2d_bytes - M * N * 4
        assert ex.last_d2h_bytes == stats["d2h_bytes"] \
            == ref_ex.last_d2h_bytes
        assert ex.last_fill_bytes == M * N * 4
        assert ref_ex.last_fill_bytes == 0
        (rec,) = obs.calls
        assert rec.fill_bytes == M * N * 4 and rec.copy_bytes == 0
        assert obs.metrics.get("repro_executor_fill_bytes").value(
            kernel="gemm") == M * N * 4
    finally:
        obs.reset().disable()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(R.ooc_gemm(A, B, budget_bytes=budget)),
        rtol=1e-4, atol=1e-4)


def _c_transfers(sched):
    """(S(c_ij) H2D ops, fill ops) of C in ``sched``."""
    ops = [op for op in sched.ops if getattr(op.payload, "operand", None)
           == "C" and op.kind != T.OpKind.D2H]
    return ([op for op in ops if op.kind == T.OpKind.H2D],
            [op for op in ops if op.kind == T.OpKind.COMPUTE])


@pytest.mark.parametrize("path", ["callers_c", "faults", "syrk", "in_core"])
def test_other_paths_still_stream_c(path, monkeypatch):
    """Everything but the no-C, host, out-of-core, fault-free GEMM keeps
    the reference-equal path: a caller's C, an armed fault plan, a SYRK
    (each streams C's blocks, S(c_ij), and fills none) and the in-core
    call (host zeros, no executor run)."""
    from repro_torch.fault import FaultPlan, FaultPolicy

    want = _host_call("syrk" if path == "syrk" else "gemm",
                      np.zeros((256, 256), np.float32))
    runs = []
    real_run = T.ScheduleExecutor.run

    def run(self, sched, *a, **kw):
        runs.append(sched)
        st = real_run(self, sched, *a, **kw)
        assert self.last_fill_bytes == 0
        return st

    monkeypatch.setattr(T.ScheduleExecutor, "run", run)
    ex = T.ScheduleExecutor(record_spans=True, torch_device=CPU)
    if path == "callers_c":
        out = _host_call("gemm", np.zeros((256, 256), np.float32), ex=ex)
    elif path == "faults":
        out = _host_call("gemm", ex=ex, faults=FaultPlan(specs=()),
                         fault_policy=FaultPolicy(sleep=lambda s: None))
    elif path == "syrk":
        out = _host_call("syrk", ex=ex)
    else:
        A, B, _ = _problem(21, 256, 256, 128)
        big = 1 << 30
        out = T.ooc_gemm(A, B, budget_bytes=big, runtime=T.HostOocRuntime(
            T.Device("HBM", 0, big), executor=ex))
    assert torch.equal(out, want)
    rec = get_observability().calls[-1]
    assert rec.fill_bytes == 0
    if path == "in_core":
        assert not runs and "gemm.zero_c" in rec.seconds
        return
    (sched,) = runs
    copied, filled = _c_transfers(sched)
    assert copied and not filled


def test_executor_fills_every_element_of_a_nan_output():
    """The fill schedule run into an output full of NaN leaves none: each
    element is written by a write-back, in both modes, and every block of
    C is a fill op that the run counts."""
    M, N, K = 300, 260, 96
    A, B, _ = _problem(82, M, N, K)
    part = T.plan_gemm_partition(M, N, K, (A.nbytes + B.nbytes + M * N * 4)
                                 // 4, 4)
    sched = T.build_gemm_schedule(part, fill_c=True)
    copied, filled = _c_transfers(sched)
    assert not copied and len(filled) == part.nblocks
    want = torch.zeros(M, N)
    T.ScheduleExecutor(torch_device=CPU).run(
        T.build_gemm_schedule(part), {"A": A, "B": B}, {"C": want},
        {"alpha": 1.0, "beta": 0.0})
    for mode in T.ScheduleExecutor.MODES:
        out = torch.full((M, N), float("nan"))
        ex = T.ScheduleExecutor(mode=mode, torch_device=CPU)
        ex.run(sched, {"A": A, "B": B}, {"C": out},
               {"alpha": 1.0, "beta": 0.0})
        assert not out.isnan().any()
        assert torch.equal(out, want)
        assert ex.last_fill_bytes == M * N * 4
        assert ex.last_h2d_bytes == T.schedule_stats(sched)["h2d_bytes"]


def test_fill_schedule_replays_from_its_zeros():
    """Armed by hand on a fill schedule, the executor takes a C block's
    clean point from its fill: a corrupted DGEMM is replayed onto the
    block's zeros and the result is the clean run's, bit for bit; a
    corrupted fill is not replayable."""
    from repro_torch.fault import (ComputeFault, FaultPlan, FaultPolicy,
                                   FaultSpec)

    M, N, K = 300, 260, 96
    A, B, _ = _problem(84, M, N, K)
    part = T.plan_gemm_partition(M, N, K, (A.nbytes + B.nbytes + M * N * 4)
                                 // 4, 4)
    sched = T.build_gemm_schedule(part, fill_c=True)
    ctx = {"alpha": 1.0, "beta": 0.0}
    want = torch.zeros(M, N)
    T.ScheduleExecutor(torch_device=CPU).run(sched, {"A": A, "B": B},
                                             {"C": want}, ctx)
    tags = [op.tag for op in sched.ops]
    dgemm = [i for i, t in enumerate(tags) if t.startswith("DGEMM")][3]
    fill = [i for i, t in enumerate(tags) if t.startswith("Z(")][2]
    pol = FaultPolicy(sleep=lambda s: None)
    ex = T.ScheduleExecutor(torch_device=CPU)
    out = torch.full((M, N), float("nan"))
    ex.run(sched, {"A": A, "B": B}, {"C": out}, ctx, policy=pol,
           faults=FaultPlan(specs=(FaultSpec(op=dgemm, cls="compute_nan"),)))
    assert torch.equal(out, want)
    assert ex.last_fault_stats["recovered_replay"] == 1
    with pytest.raises(ComputeFault, match="not replayable"):
        ex.run(sched, {"A": A, "B": B}, {"C": torch.empty(M, N)}, ctx,
               policy=pol, faults=FaultPlan(specs=(
                   FaultSpec(op=fill, cls="compute_nan"),)))


def test_fill_schedule_refuses_a_callers_c():
    """A schedule that makes C on the device ignores C's values, so the
    runtime refuses a caller's C with it."""
    A, B, C = _problem(83, 256, 256, 128)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    part = T.plan_gemm_partition(256, 256, 128, budget, 4)
    rt = T.HostOocRuntime(T.Device("HBM", 0, budget), torch_device=CPU)
    with pytest.raises(ValueError, match="fill_c"):
        rt.gemm(A, B, C, 1.0, 0.0, part,
                schedule=T.build_gemm_schedule(part, fill_c=True))
