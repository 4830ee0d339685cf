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
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")


@pytest.mark.parametrize("entry", ["ooc_gemm", "ooc_syrk", "executor",
                                   "host_runtime", "vmem_runtime",
                                   "tier_size"])
def test_default_device_raises_without_a_card(no_card, entry):
    import numpy as np

    import repro_torch.core as T
    from repro_torch.core.api import hclDeviceFactory

    A = np.ones((64, 64), np.float32)
    calls = {
        "ooc_gemm": lambda: T.ooc_gemm(A, A, budget_bytes=1 << 12),
        "ooc_syrk": lambda: T.ooc_syrk(A, budget_bytes=1 << 12),
        "executor": lambda: T.ScheduleExecutor(),
        "host_runtime": lambda: T.HostOocRuntime(),
        "vmem_runtime": lambda: T.VmemOocRuntime(),
        "tier_size": lambda: hclDeviceFactory.create("HBM"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


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
