"""MMOOC end to end: the port's ``ooc_gemm``/``ooc_syrk`` against the
reference's, on the CPU (plain kernel versions), on the shapes of
``test_oocgemm.py`` — plus the bit-for-bit invariants the kernel's fixed
K order gives the port: the out-of-core result equals the in-core one for
every traversal and eviction policy, and the vmem backend agrees too.
"""

import jax.numpy as jnp
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
    (dict(tune="auto"), "item 7"),
    (dict(devices=[("gpu0", None, 1 << 20)]), "item 8"),
    (dict(faults=object()), "item 6"),
    (dict(backend="mesh"), "item 10"),
])
def test_paths_outside_the_slice_raise(kw, item):
    A, B, C = _problem(61, 64, 64, 64)
    with pytest.raises(NotImplementedError, match=item):
        T.ooc_gemm(A, B, C, budget_bytes=1 << 12, torch_device=CPU, **kw)
    with pytest.raises(NotImplementedError, match=item):
        T.ooc_syrk(A, budget_bytes=1 << 12, torch_device=CPU, **kw)


@pytest.mark.parametrize("tier,item", [("MESH", "item 10"),
                                       ("HYBRID", "item 8")])
def test_tiers_outside_the_slice_raise(tier, item):
    with pytest.raises(NotImplementedError, match=item):
        T.RuntimeFactory.create(T.Device(tier, 0, 1 << 20),
                                torch_device=CPU)
    with pytest.raises(NotImplementedError, match=item):
        hclDeviceFactory.create(tier, 0, mem_bytes=1 << 20)
