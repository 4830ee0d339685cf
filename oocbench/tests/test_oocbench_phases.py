"""CPU tests of the readers of the program's call records: ``entry_host_s``,
``entry_copy_gbps``, ``plan_ms`` and ``land_share``."""

import json
import pathlib

import pytest

from oocbench.harness import bench
from oocbench.harness.manifest import Manifest
from oocbench.harness.record import Call, ExecRun, Run
from oocbench_tiny import tiny  # noqa: F401  (the fixture)
from repro_torch.obs import CallRecord, get_observability

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
READERS = ["entry_host_s", "entry_copy_gbps", "plan_ms", "land_share"]


@pytest.fixture(autouse=True)
def _fresh_records():
    get_observability().calls.clear()
    yield
    get_observability().calls.clear()


def check_call_records(root, cell):
    """A traced run of ``cell`` reads each of these readers that the
    manifest lists for the cell from the program's call records."""
    res = bench.run_cell(root, cell, 2**31 + 7, 0.3, True, "cpu")
    assert res["correct"]
    listed = {e["name"] for e in Manifest(root).metrics(cell, True)}
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in set(READERS) & listed:
        assert got.get(name) is not None, name
        assert got[name] > 0, name
    if {"entry_host_s", "outside_exec_s"} <= listed:
        assert got["entry_host_s"] <= got["outside_exec_s"]
    if "land_share" in listed:
        assert got["land_share"] <= 100.0


def check_untraced_records_nothing(root, cell):
    res = bench.run_cell(root, cell, 2**31 + 7, 0.2, False, "cpu")
    assert res["correct"]
    assert not set(READERS) & set(res["metrics"])
    assert len(get_observability().calls) == 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_call_records(tiny, cell):
    check_call_records(tiny, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_lists_none_and_records_nothing(tiny, cell):
    check_untraced_records_nothing(tiny, cell)


def _run(walls):
    """A hand-made run of a GEMM cell: one call per entry of ``walls``,
    each with one executor run of that wall."""
    execs = [[ExecRun(sched=None, shapes={}, ctx={}, wall_s=w, stage_s=0.0,
                      stage_wait_s=0.0, h2d_bytes=0, d2h_bytes=0, spans=[])]
             for w in walls]
    return Run(cell={"name": "gemm.hand-made", "chips": 1},
               config={"entry": "gemm", "dtype": "float32"}, traffic={},
               peaks=None, setup_s=0.0, window_s=1.0,
               calls=[Call(operand_set=0, wall_s=2.0, flops=1.0, execs=e)
                      for e in execs])


def _record(wall, ok=True):
    rec = CallRecord("gemm")
    for name, s in (("gemm.intake", 0.01), ("gemm.zero_c", 0.2),
                    ("gemm.plan", 0.003), ("gemm.clone_c", 0.3),
                    ("gemm.execute", wall), ("executor.land", wall / 4)):
        rec.add(name, s, 1000 if name.endswith("_c") else 0)
    rec.add("gemm", wall + 0.6)
    rec.exec_walls.append(wall)
    rec.ok = ok
    return rec


@pytest.mark.parametrize("name", READERS)
def test_reader_joins_records_to_calls(name):
    obs = get_observability()
    obs.calls.extend([_record(0.5), _record(0.75), _record(9.0, ok=False)])
    value = Manifest(ROOT).module("metrics", name).read(_run([0.5, 0.75]))
    want = {"entry_host_s": 0.513, "entry_copy_gbps": 4000 / 1.0 / 1e9,
            "plan_ms": 3.0, "land_share": 25.0}[name]
    assert value == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["short", "mismatch", "other_entry"])
def test_reader_without_matching_records_reads_none(name, case):
    obs = get_observability()
    if case == "short":
        obs.calls.append(_record(0.75))
    elif case == "mismatch":
        obs.calls.extend([_record(0.5), _record(0.7500001)])
    else:
        for rec in (_record(0.5), _record(0.75)):
            rec.entry = "cholesky"
            obs.calls.append(rec)
    run = _run([0.5, 0.75])
    assert Manifest(ROOT).module("metrics", name).read(run) is None
