"""The control of each cell comes out as not correct, the program as
correct, at a size the CPU holds: ``oocbench/control.py``'s readings of
the program and of the plain reference computed in the nearest precision
below the configuration's (TF32 for float32), on three seeds, against the
cell's own limit.  On the card the same readings, at the cells' sizes and
on a dozen seeds, are what the limits were set from (``PERF.md``)."""

import io
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "oocbench"))
import control  # noqa: E402
from oocbench_tiny import tiny  # noqa: F401  (the fixture)

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def check_control(root, cell):
    limit = json.loads((root / "oocbench" / "limits" / f"{cell}.json")
                       .read_text())["max_err"]["limit"]
    rows, summary = control.readings(root, cell, [1, 2**31 + 1, 4242],
                                     "cpu", log=io.StringIO())
    assert len(rows) == 3
    assert all(r["program"] <= limit < r["control"] for r in rows), rows
    assert summary["upper"] >= 3 * summary["lower"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_and_the_program_passes(tiny, cell):
    check_control(tiny, cell)
