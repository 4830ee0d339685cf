"""Import and device hygiene of the port.

``repro_torch`` and ``chip_smoke.py`` must never load JAX or the reference
package (the port runs where neither exists), and the port's entry points
must refuse to run on the CPU unless the caller asks for it.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)",
                       re.MULTILINE)


def test_package_imports_without_jax_or_reference():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "repro" or n.startswith("repro.")
             or (n.split(".")[0] == "jax" and sys.modules[n] is not None))
print("LOADED", len([n for n in sys.modules if n.startswith("repro_torch")]))
assert not bad, bad
assert {"repro_torch.fault." + m for m in ("errors", "plan", "policy",
        "replay")} <= set(sys.modules)
assert {"repro_torch.hybrid." + m for m in ("balance", "plan",
        "executor")} <= set(sys.modules)
assert {"repro_torch.examples." + m for m in ("hybrid_gemm",
        "faulty_gemm", "observed_gemm")} <= set(sys.modules)
assert {"repro_torch.obs.analyze", "repro_torch.obs.whatif",
        "repro_torch.scripts.export_trace",
        "repro_torch.scripts.run_report"} <= set(sys.modules)
assert {"repro_torch.configs", "repro_torch.configs.base",
        "repro_torch.models.layers", "repro_torch.models.moe",
        "repro_torch.models.transformer", "repro_torch.models.convert",
        "repro_torch.models.base", "repro_torch.models.mamba2",
        "repro_torch.models.rwkv6", "repro_torch.models.zamba2",
        "repro_torch.training.steps", "repro_torch.launch.serve",
        "repro_torch.examples.serve_decode", "repro_torch.optim.adamw",
        "repro_torch.optim.compression", "repro_torch.data.pipeline",
        "repro_torch.checkpoint.manager", "repro_torch.launch.train",
        "repro_torch.examples.train_lm", "repro_torch.distributed",
        "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
        "repro_torch.models.spmd", "repro_torch.launch.dryrun",
        "repro_torch.distributed.cost_analysis",
        "repro_torch.scripts.make_tables"} <= set(sys.modules)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


def test_dry_run_touches_no_group_or_environment_at_import():
    """Importing the dry-run and its cost analysis sets no environment
    variable (the reference's first line sets ``XLA_FLAGS``) and brings up
    no process group: ``run_cell`` makes its fake one itself."""
    code = """
import os
before = dict(os.environ)
import torch.distributed as dist
import repro_torch.launch.dryrun, repro_torch.distributed.cost_analysis
import repro_torch.scripts.make_tables
assert dict(os.environ) == before
assert not dist.is_initialized()
print("CLEAN")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert res.returncode == 0 and res.stdout.split()[-1] == "CLEAN", \
        res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_direct_impls_import_no_kernel_but_build():
    """The direct baselines carry their own kernel: ``direct_impls.py``
    imports nothing of ``repro_torch.kernels`` but the build helper."""
    import ast

    src = (ROOT / "src" / "repro_torch" / "direct_impls.py").read_text()
    names = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [f"{node.module}.{a.name}" for a in node.names]
    kernels = [n for n in names if n.startswith("repro_torch.kernels")]
    assert kernels == ["repro_torch.kernels._build"], kernels


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")


@pytest.mark.parametrize("entry", ["ooc_gemm", "ooc_syrk", "ooc_attention",
                                   "executor", "host_runtime",
                                   "vmem_runtime", "tier_size",
                                   "direct_host", "direct_vmem", "mmooc",
                                   "calibrate", "autotuner", "hybrid_gemm",
                                   "hybrid_syrk", "hybrid_attention",
                                   "hybrid_cholesky", "hybrid_runtime",
                                   "hybrid_factory", "run_hybrid_gemm",
                                   "transformer_model", "get_model",
                                   "serve_main", "mamba2_model",
                                   "rwkv6_model", "zamba2_model",
                                   "get_model_ssm", "serve_main_hybrid",
                                   "train_main"])
def test_default_device_raises_without_a_card(no_card, entry):
    import numpy as np

    import repro_torch.core as T
    import repro_torch.hybrid as TH
    import repro_torch.tune as TT
    from repro_torch import direct_impls as D
    from repro_torch.core.api import hclDeviceFactory, hclHybridRuntime
    from repro_torch.configs import get_arch
    from repro_torch.examples.mmooc_via_api import mmooc
    from repro_torch.launch import serve, train
    from repro_torch.models import (Mamba2Model, RWKV6Model,
                                    TransformerModel, Zamba2Model, get_model)

    A = np.ones((64, 64), np.float32)
    cfg = get_arch("llama3.2-3b").smoke()
    devs = [TH.DeviceSpec("gpu0", TT.gpu_profile(), 1 << 16),
            TH.DeviceSpec("phi0", TT.phi_profile(), 1 << 16)]
    calls = {
        "ooc_gemm": lambda: T.ooc_gemm(A, A, budget_bytes=1 << 12),
        "ooc_syrk": lambda: T.ooc_syrk(A, budget_bytes=1 << 12),
        "ooc_attention": lambda: T.ooc_attention(
            A, A.reshape(64, 1, 64), A.reshape(64, 1, 64),
            budget_bytes=1 << 16),
        "executor": lambda: T.ScheduleExecutor(),
        "host_runtime": lambda: T.HostOocRuntime(),
        "vmem_runtime": lambda: T.VmemOocRuntime(),
        "tier_size": lambda: hclDeviceFactory.create("HBM"),
        "direct_host": lambda: D.direct_host_ooc_gemm(A, A, A, 1.0, 0.0,
                                                      1 << 12),
        "direct_vmem": lambda: D.direct_vmem_ooc_gemm(A, A, A, 1.0, 0.0),
        "mmooc": lambda: mmooc(A, A, A, 1.0, 0.0, mem_bytes=1 << 12),
        "calibrate": lambda: TT.calibrate(),
        "autotuner": lambda: TT.AutoTuner(profile=TT.gpu_profile()).gemm_plan(
            1024, 1024, 512, 1 << 20),
        "hybrid_gemm": lambda: T.ooc_gemm(A, A, budget_bytes=1,
                                          devices=devs),
        "hybrid_syrk": lambda: T.ooc_syrk(A, budget_bytes=1, devices=devs),
        "hybrid_attention": lambda: T.ooc_attention(
            A, A.reshape(64, 1, 64), A.reshape(64, 1, 64), budget_bytes=1,
            devices=devs),
        "hybrid_cholesky": lambda: T.ooc_cholesky(
            A + 64 * np.eye(64, dtype=np.float32), panel=32, budget_bytes=1,
            devices=devs),
        "hybrid_runtime": lambda: hclHybridRuntime(devs),
        "hybrid_factory": lambda: T.RuntimeFactory.create(
            hclDeviceFactory.create("HYBRID"), devices=devs),
        "run_hybrid_gemm": lambda: TH.run_hybrid_gemm(
            A, A, None, 1.0, 0.0, None),
        "transformer_model": lambda: TransformerModel(cfg),
        "get_model": lambda: get_model(cfg),
        "serve_main": lambda: serve.main(["--arch", "llama3.2-3b",
                                          "--smoke"]),
        "mamba2_model": lambda: Mamba2Model(
            get_arch("zamba2-1.2b").smoke().replace(shared_attn_every=0,
                                                    family="ssm")),
        "rwkv6_model": lambda: RWKV6Model(get_arch("rwkv6-1.6b").smoke()),
        "zamba2_model": lambda: Zamba2Model(get_arch("zamba2-1.2b").smoke()),
        "get_model_ssm": lambda: get_model(get_arch("rwkv6-1.6b").smoke()),
        "serve_main_hybrid": lambda: serve.main(["--arch", "zamba2-1.2b",
                                                 "--smoke"]),
        "train_main": lambda: train.main(["--arch", "stablelm-1.6b",
                                          "--smoke", "--steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.parametrize("name", ["hybrid_gemm", "faulty_gemm"])
def test_hybrid_examples_need_a_card_without_cpu_flag(no_card, name,
                                                      tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--trace",
         str(tmp_path / "t.json")] if name == "hybrid_gemm" else
        [sys.executable, "-m", f"repro_torch.examples.{name}"],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "OK" not in res.stdout


def test_train_example_needs_a_card_without_cpu_flag(no_card, tmp_path):
    """``train_lm`` trains on the card unless ``--cpu`` is given: no
    fallback to the host, and no checkpoint written."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm", "--quick"],
        capture_output=True, text=True, cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "OK" not in res.stdout
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("args", [
    ["repro_torch.examples.observed_gemm"],
    ["repro_torch.scripts.export_trace", "--mode", "exec", "--M", "64",
     "--N", "64", "--K", "64", "--budget-mb", "0.05"],
    ["repro_torch.scripts.run_report", "--check"]],
    ids=["observed_gemm", "export_trace", "run_report"])
def test_analysis_tools_need_a_card_without_cpu_flag(no_card, args,
                                                     tmp_path):
    """The example and the two scripts that run kernels raise without a
    card unless ``--cpu`` is given: no fallback to the host."""
    res = subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True,
        cwd=tmp_path, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "OK" not in res.stdout and "passed" not in res.stdout
    assert not (tmp_path / "trace.json").exists()


def test_analysis_needs_no_core_at_import():
    """``repro_torch.obs`` resolves the analysis exports lazily (the core
    runtime imports the package first), and they no longer raise."""
    code = """
import sys
import repro_torch.obs as O
assert "repro_torch.obs.analyze" not in sys.modules
assert O.TraceAnalysis.__module__ == "repro_torch.obs.analyze"
assert O.WhatIfReport.__module__ == "repro_torch.obs.whatif"
assert callable(O.__getattr__("whatif"))
from repro_torch.core.api import hclTraceAnalysis
from repro_torch.hybrid.executor import HybridAnalysis, analyze_hybrid
import repro_torch.core.runtime as rt
assert not hasattr(rt, "NOT_PORTED")
assert "MESH" in rt.RuntimeFactory.registered()
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_a_card(no_card, tmp_path):
    """No result line and a non-zero exit, both in the checkout and in a
    directory holding the script alone."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True,
                             cwd=script.parent, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
