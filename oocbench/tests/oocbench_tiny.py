"""The fixture of the benchmark's CPU tests: a copy of the benchmark's
folder whose cells are cut to sizes that the CPU runs in moments.

These tests are run on their own (``python -m pytest -q oocbench/tests``);
the repository's suite does not collect them.  A test module imports
:func:`tiny` to use it.
"""

import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "oocbench"

# a size per entry point at which the CPU runs a call in milliseconds and
# every call is still out of core (the operands exceed the budget)
TINY = {"gemm": {"m": 192, "n": 160, "k": 128, "budget_bytes": 128 << 10},
        "cholesky": {"n": 256, "budget_bytes": 256 << 10, "panel": 32}}


def tiny_root(dest: pathlib.Path) -> pathlib.Path:
    """``dest`` holding ``BENCHMARK.json`` and a copy of ``oocbench/`` whose
    configurations are cut to :data:`TINY`; the limits stay the cells'."""
    shutil.copytree(BENCH, dest / "oocbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["entry"]])
        path.write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
