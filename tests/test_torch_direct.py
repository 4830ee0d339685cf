"""The paper's direct baselines: the port's ``direct_impls`` against the
reference's ``benchmarks/direct_impls.py`` on the CPU (kernels' plain
versions), the example ports, and claim C4's line count.

``direct_host_ooc_gemm`` must build the reference's schedule op for op and
give its result; ``direct_vmem_ooc_gemm`` on ``torch_device="cpu"`` must
match the reference's Pallas kernel in interpret mode at
``tests/test_kernels.py``'s tolerances.  Kernel 3 itself runs only on the
card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.runtime as R_runtime
import repro_torch.core as T
import repro_torch.core.runtime as T_runtime
from benchmarks import direct_impls as R_direct
from benchmarks.bench_loc import _code_lines_of
from repro_torch import direct_impls as D
from repro_torch.core.convert import from_reference
from repro_torch.examples.mmooc_via_api import mmooc

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_helpers import op_key

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
# (M, N, K, budget fraction of the operands); 300x200x150 is no multiple of
# the 8-row / 128-column steps
HOST_CASES = [(384, 256, 192, 5), (640, 384, 256, 4), (300, 200, 150, 3),
              (1024, 1024, 512, 6)]


def _problem(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


def _capture(monkeypatch, cls, into):
    """Record every schedule ``cls.run`` is given, then run it."""
    run = cls.run

    def recording(self, sched, *a, **kw):
        into.append(sched)
        return run(self, sched, *a, **kw)

    monkeypatch.setattr(cls, "run", recording)


@pytest.mark.parametrize("M,N,K,frac", HOST_CASES)
def test_direct_host_schedule_matches_reference(monkeypatch, M, N, K, frac):
    A, B, C = _problem(M + N + K, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    ref_scheds, port_scheds = [], []
    _capture(monkeypatch, R_runtime.ScheduleExecutor, ref_scheds)
    _capture(monkeypatch, T_runtime.ScheduleExecutor, port_scheds)
    R_direct.direct_host_ooc_gemm(A, B, C, 1.5, 0.5, budget)
    D.direct_host_ooc_gemm(A, B, C, 1.5, 0.5, budget, torch_device=CPU)
    (ref,), (port,) = ref_scheds, port_scheds
    assert [op_key(o) for o in ref.ops] == [op_key(o) for o in port.ops]
    assert len(port.streams) == 1 and port.device == from_reference(
        ref.device)
    assert from_reference(ref) == port


@pytest.mark.parametrize("M,N,K,frac", HOST_CASES)
def test_direct_host_output_and_bytes(monkeypatch, M, N, K, frac):
    A, B, C = _problem(M * 3 + N, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // frac
    ref = R_direct.direct_host_ooc_gemm(A, B, C, 1.5, 0.5, budget)
    ex = T.ScheduleExecutor(async_writeback=True, torch_device=CPU)
    scheds = []
    _capture(monkeypatch, T_runtime.ScheduleExecutor, scheds)
    C_before = C.copy()
    out = D.direct_host_ooc_gemm(A, B, C, 1.5, 0.5, budget, executor=ex)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert np.array_equal(C, C_before)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    expect = 1.5 * (A.astype(np.float64) @ B) + 0.5 * C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    stats = T.schedule_stats(scheds[0])
    assert (ex.last_h2d_bytes, ex.last_d2h_bytes) \
        == (stats["h2d_bytes"], stats["d2h_bytes"])
    assert stats["d2h_bytes"] == C.nbytes


@pytest.mark.parametrize("block", [(128, 128, 128), (256, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K", [(300, 200, 150), (512, 128, 257),
                                   (256, 256, 256)])
def test_direct_vmem_matches_reference_interpret(M, N, K, dtype, block):
    A, B, C = _problem(M + 2 * N + K, M, N, K)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = R_direct.direct_vmem_ooc_gemm(
        *(jnp.asarray(x, jdt) for x in (A, B, C)), 1.25, 0.5, block=block,
        interpret=True)
    Ct = torch.from_numpy(C).to(tdt)
    C_before = Ct.clone()
    out = D.direct_vmem_ooc_gemm(torch.from_numpy(A).to(tdt),
                                 torch.from_numpy(B).to(tdt), Ct, 1.25, 0.5,
                                 block=block, torch_device=CPU)
    assert out.dtype == tdt and tuple(out.shape) == (M, N)
    assert torch.equal(Ct, C_before)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_direct_vmem_checks_its_arguments():
    A, B, C = (torch.from_numpy(x) for x in _problem(1, 64, 48, 32))
    call = lambda *a, **kw: D.direct_vmem_ooc_gemm(*a, torch_device=CPU,
                                                   **kw)
    with pytest.raises(ValueError, match="column stride"):
        call(A.T.contiguous().T, B, C, 1.0, 0.0)
    with pytest.raises(TypeError, match="one dtype"):
        call(A, B.half(), C, 1.0, 0.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        call(A, B[:16], C, 1.0, 0.0)
    with pytest.raises(ValueError, match="block"):
        call(A, B, C, 1.0, 0.0, block=(128, 0, 128))
    # float64 is computed in float32, as the reference does with x64 off
    out64 = call(A.double(), B.double(), C.double(), 1.5, 0.5)
    assert out64.dtype == torch.float32
    assert torch.equal(out64, call(A, B, C, 1.5, 0.5))
    # row-strided views are taken as they are
    wide = torch.zeros(64, 80)
    wide[:, 8:40] = A
    assert torch.equal(call(wide[:, 8:40], B, C, 1.5, 0.5),
                       call(A, B, C, 1.5, 0.5))


@pytest.mark.parametrize("name", ["mmooc_via_api", "quickstart",
                                  "concurrent_gemm", "ooc_attention_demo"])
def test_example_ports_run_on_cpu(name):
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert f"{name} OK" in res.stdout.splitlines()[-1]
    if name in ("quickstart", "ooc_attention_demo"):
        assert "model estimate" in res.stdout and "tpu" not in res.stdout
        assert "v5e" not in res.stdout


@pytest.mark.parametrize("name,last,expect", [
    ("autotune_gemm", "autotune quickstart OK",
     ("second call: served from plan cache",
      "gpu-like: picked nstreams=2", "phi-like: picked nstreams=1")),
    ("ooc_lu", "ooc factorization quickstart OK",
     ("rows pivoted", "(1 search, then cache hits)"))])
def test_tune_example_ports_run_on_cpu(name, last, expect):
    """The ports of the two tuner examples, with the reference's last
    lines: the one-liner calibrates this CPU, and the canned profiles
    reproduce claim C5's stream choice."""
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == last
    for text in expect:
        assert text in res.stdout, text


@pytest.mark.parametrize("name,last", [
    ("hybrid_gemm", "hybrid quickstart OK"),
    ("faulty_gemm", "faulty gemm quickstart OK")])
def test_hybrid_example_ports_run_on_cpu(name, last, tmp_path):
    """The ports of the two examples that import the hybrid package, with
    the reference's last lines: every recovery bitwise, the hybrid GEMM
    exact against numpy and the trace written where it was asked to."""
    trace = tmp_path / "hybrid_trace.json"
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--cpu"]
        + (["--trace", str(trace)] if name == "hybrid_gemm" else []),
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == last
    if name == "faulty_gemm":
        assert res.stdout.count("bitwise identical: True") == 4
        assert "rebalance gpu0" in res.stdout
    else:
        assert "(model estimate)" in res.stdout and trace.exists()
        assert "gpu0: rows [0, " in res.stdout


def test_mmooc_port_matches_reference_example():
    from examples.mmooc_via_api import mmooc as R_mmooc

    A, B, C = _problem(3, 384, 256, 192)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5
    ref = R_mmooc(A, B, C, 1.5, 0.5, "HBM", mem_bytes=budget)
    out = mmooc(A, B, C, 1.5, 0.5, "HBM", mem_bytes=budget, torch_device=CPU)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def _cuda_code_lines(path: pathlib.Path) -> int:
    """Non-blank lines of a CUDA source outside ``//`` and ``/* */``
    comments (the C++ counterpart of ``bench_loc._code_lines_of``)."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.DOTALL)
    return sum(1 for ln in text.splitlines()
               if ln.strip() and not ln.strip().startswith("//"))


def test_c4_loc_reduction():
    """Claim C4: the port's MMOOC written against the API is at least 75 %
    shorter than the three direct tiers it replaces (host, vmem with
    kernel 3's CUDA source, and the mesh ring), as
    ``benchmarks/bench_loc.py`` counts them."""
    api = _code_lines_of(mmooc)
    direct = {"host": _code_lines_of(D.direct_host_ooc_gemm),
              "vmem": _code_lines_of(D.direct_vmem_ooc_gemm),
              "vmem_cuda": _cuda_code_lines(
                  ROOT / "src/repro_torch/csrc/direct_vmem_gemm.cu"),
              "mesh": _code_lines_of(D.direct_mesh_ooc_gemm)}
    assert api <= 10 and all(v > 0 for v in direct.values()), direct
    reduction = 1 - api / sum(direct.values())
    print(f"C4: mmooc {api} lines vs direct {direct} = "
          f"{sum(direct.values())}: {100 * reduction:.1f} % fewer")
    assert reduction >= 0.75, (api, direct)
