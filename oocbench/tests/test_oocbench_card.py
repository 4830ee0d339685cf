"""The benchmark's runs on a card: each cell, traced, with a short window.

Run on a machine with a card: ``python -m pytest -q -m cuda
oocbench/tests/test_oocbench_card.py``.  Elsewhere it skips.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "oocbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "4", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert 0 < dev["busy_s"] <= dev["window_s"]
    want = {m["name"] for m in MANIFEST["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert 0 < len(res["breakdown"]["device_ops"]) <= 10
    assert 0 < len(res["breakdown"]["idle_gaps"]) <= 10
