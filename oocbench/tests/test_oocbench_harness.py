"""CPU tests of the benchmark's harness: its counts of operations and bytes,
its references, its manifest, and that a cell, a traffic mix and a metric
are taken from added files alone."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from oocbench.harness import bench, ops, traffic as tgen
from oocbench.harness.manifest import Manifest
from oocbench.harness.record import recording_executor
from oocbench.reference.precision import tf32
from oocbench_tiny import cut_of, tiny  # noqa: F401  (the fixture)

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _executed(root, cell, seed=7):
    """One call of ``cell`` (under ``root``) on the CPU: its runs and
    the shapes of its operands."""
    man = Manifest(root)
    _, cfg, mix, driver, _ = man.parts(cell)
    ex = recording_executor(torch_device="cpu")
    handle = driver.prepare(cfg, ex)
    sets = tgen.make_sets(mix, cfg, seed, "cpu")
    driver.call(handle, sets[0], dict(mix.get("scalars", {})), cfg)
    return man, cfg, mix, ex.runs


def check_counts(root, cell):
    """The harness's own counts against the program's ``schedule_stats``:
    every run's transfer bytes equal; where a schedule has ``dgemm`` ops,
    its block products from the transfers' slices, whose ``2 m n k`` the
    program's flops hold with their epilogues (``alpha``, ``beta``: at most
    3 per output element); and the reference's useful work against the
    work the schedules count, as the entry point's cut says."""
    from repro_torch.core import schedule_stats

    man, cfg, mix, runs = _executed(root, cell)
    assert runs
    counted = 0
    for er in runs:
        st = schedule_stats(er.sched)
        for kind in ("H2D", "D2H"):
            moved = sum(er.sched.ops[i].bytes for i in ops.ops_where(er, kind))
            assert moved == st[f"{kind.lower()}_bytes"] \
                == getattr(er, f"{kind.lower()}_bytes")
        prods = list(ops.block_products(er))
        dgemm = ops.ops_where(er, "COMPUTE", ("dgemm",))
        assert sorted(i for i, *_ in prods) == dgemm
        if not prods:
            counted += st["flops"]
            continue
        for i, m, n, k in prods:
            mine = ops.product_flops(m, n, k)
            assert mine <= er.sched.ops[i].flops <= mine + 3 * m * n
        total = sum(ops.product_flops(m, n, k) for _, m, n, k in prods)
        assert total <= st["flops"]
        counted += total
    useful = man.module("reference", cfg["entry"]).useful_flops(
        tgen.shapes(mix, cfg))
    relation = cut_of(root, cfg["entry"])["useful_flops"]
    assert relation in ("equal", "below"), relation
    assert useful == counted if relation == "equal" else useful < counted


@pytest.mark.parametrize("cell", CELLS)
def test_counts_match_schedule_stats(tiny, cell):
    check_counts(tiny, cell)


def test_product_bytes_and_slices():
    class Ref:
        operand, rows, cols, transpose = "A", (4, 3), None, True

    assert ops.slice_shape(Ref, {"A": (10, 6)}) == (6, 3)
    assert ops.product_bytes(2, 3, 4, 0.0, 4) == (8 + 12 + 6) * 4
    assert ops.product_bytes(2, 3, 4, 1.0, 4) == (8 + 12 + 12) * 4


def _load(kind, name):
    return Manifest(ROOT).module(kind, name)


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_gemm_reference_against_numpy(seed):
    ref = _load("reference", "gemm")
    g = np.random.default_rng(seed)
    a = g.standard_normal((70, 33), dtype=np.float32)
    b = g.standard_normal((33, 41), dtype=np.float32)
    c = g.standard_normal((70, 41), dtype=np.float32)
    want = 1.5 * (a.astype(np.float64) @ b) - 0.5 * c
    got = ref.solve({"A": torch.from_numpy(a), "B": torch.from_numpy(b),
                     "C": torch.from_numpy(c)},
                    {"alpha": 1.5, "beta": -0.5})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    no_c = ref.solve({"A": torch.from_numpy(a), "B": torch.from_numpy(b)},
                     {"alpha": 2.0, "beta": 3.0})
    np.testing.assert_allclose(no_c.numpy(), 2.0 * (a.astype(np.float64)
                                                    @ b), rtol=1e-5,
                               atol=1e-4)
    assert ref.useful_flops({"A": (70, 33), "B": (33, 41)}) \
        == 2 * 70 * 41 * 33


def test_tf32_rounding():
    x = torch.randn(10000)
    r = tf32(x)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(tf32(r), r)


def test_gemm_control_rounds_to_tf32():
    """The control of float32 operands multiplies them in TF32, and reads
    far from the reference."""
    ref = _load("reference", "gemm")
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(64, 96, generator=g), torch.randn(96, 48, generator=g)
    ctl = ref.solve({"A": a, "B": b}, {}, control=True)
    assert torch.equal(ctl, ref.solve({"A": tf32(a), "B": tf32(b)}, {}))
    want = ref.solve({"A": a, "B": b}, {})
    assert float((ctl - want).abs().max() / want.abs().max()) > 1e-5


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_cholesky_reference_against_numpy(seed):
    ref = _load("reference", "cholesky")
    gen = torch.Generator().manual_seed(seed)
    a = tgen.DISTS["spd_gram"]((96, 96), gen, {"mean": 1.0, "shift": 1.0},
                               torch.float32)
    assert torch.equal(a, a.T)
    want = np.linalg.cholesky(a.numpy().astype(np.float64))
    got = ref.solve({"A": a}, {})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    ctl = ref.solve({"A": a}, {}, control=True)
    gap = np.abs(ctl.numpy() - want).max() / np.abs(want).max()
    assert 1e-6 < gap < 1e-2
    assert ref.useful_flops({"A": (96, 96)}) == 96 ** 3 / 3


def test_operands_follow_the_seed_and_shapes():
    mix = {"loop": "closed", "operand_sets": 2,
           "operands": {"A": {"shape": ["n", 8], "dist": "normal"}}}
    cfg = {"n": 5, "dtype": "float32"}
    one = tgen.make_sets(mix, cfg, 2**31 + 11, "cpu")
    two = tgen.make_sets(mix, cfg, 2**31 + 11, "cpu")
    other = tgen.make_sets(mix, cfg, 12, "cpu")
    assert [s["A"].shape for s in one] == [(5, 8)] * 2
    assert all(torch.equal(x["A"], y["A"]) for x, y in zip(one, two))
    assert not torch.equal(one[0]["A"], one[1]["A"])
    assert not torch.equal(one[0]["A"], other[0]["A"])


def test_manifest_names_units_and_files():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "oocbench/run.py"]
    assert m["paths"] == ["oocbench"] and 1 <= m["run_seconds"] <= 51
    man = Manifest(ROOT)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("oocbench/")
        cfg = man.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert set(cfg["departures"]) == set(c["reduced"])
    for w in CELLS:
        check_cell_files(ROOT, w)
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    perf = (ROOT / "PERF.md").read_text()
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert (man.bench / "metrics" / f"{e['name']}.py").is_file()
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["moves"] in e2e and f"| {e['layer']} |" in perf
        assert set(e.get("workloads", CELLS)) <= set(CELLS)


def check_cell_files(root, cell):
    """A cell's entry and the files it names: its configuration's driver,
    reference and cut; a mix whose operand sizes are configuration keys
    that the cut reaches; its limits; its metrics' readers, setup_s,
    another end-to-end metric and a per-layer one."""
    man = Manifest(root)
    w = man.cell(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg = man.config(w["config"])
    for kind in ("drivers", "reference"):
        assert (man.bench / kind / f"{cfg['entry']}.py").is_file()
    cut = cut_of(root, cfg["entry"])
    assert set(cut) >= {"config", "useful_flops", "fault"}
    assert set(cut["config"]) <= set(cfg)
    for name, spec in man.traffic(w["traffic"])["operands"].items():
        for d in spec["shape"]:
            assert isinstance(d, str) and d in cut["config"], (name, d)
    assert man.limits(cell)["max_err"]["limit"] > 0
    e2e = man.metrics(cell, False)
    assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2
    assert man.metrics(cell, True)
    for e in e2e + man.metrics(cell, True):
        assert (man.bench / "metrics" / f"{e['name']}.py").is_file()


def test_new_cell_mix_and_metric_from_files_alone(tiny):
    """A configuration, a traffic mix, a cell's limits and a metric added as
    files (and entries of ``BENCHMARK.json``) run with no edit of code."""
    bench_dir = tiny / "oocbench"
    cfg = json.loads((bench_dir / "configs" / "mmooc-f32.json").read_text())
    cfg.update(name="mmooc-f32-b", budget_bytes=96 << 10, k=64)
    (bench_dir / "configs" / "mmooc-f32-b.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "update.json").write_text(json.dumps({
        "loop": "closed", "operand_sets": 3,
        "operands": {"A": {"shape": ["m", "k"], "dist": "normal"},
                     "B": {"shape": ["k", "n"], "dist": "normal"},
                     "C": {"shape": ["m", "n"], "dist": "normal"}},
        "scalars": {"alpha": -1.0, "beta": 1.0},
        "check": {"rows_per_call": 16, "full_per_set": 1}}))
    (bench_dir / "limits" / "mmooc-f32-b.update.json").write_text(
        json.dumps({"max_err": {"limit": 6e-5}}))
    (bench_dir / "metrics" / "calls.per_set.py").write_text(
        "def read(run):\n    return len(run.calls) / 3\n")
    m = json.loads((tiny / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "mmooc-f32-b", "source": "x",
                         "file": "oocbench/configs/mmooc-f32-b.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "mmooc-f32-b.update",
                           "config": "mmooc-f32-b", "traffic": "update",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "calls.per_set", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry points", "moves": "tflops",
                           "workloads": ["mmooc-f32-b.update"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(m))
    check_cell_files(tiny, "mmooc-f32-b.update")
    res = bench.run_cell(tiny, "mmooc-f32-b.update", 5, 0.3, True, "cpu")
    assert res["correct"] and res["attempted"] >= 3
    assert res["metrics"]["calls.per_set"]["value"] > 0
    assert "panel_ms" not in res["metrics"]
    other = bench.run_cell(tiny, "mmooc-f32.k8192", 5, 0.2, True, "cpu")
    assert "calls.per_set" not in other["metrics"]


def check_result_line(root, cell, trace, monkeypatch):
    """A run of ``cell`` on the CPU prints a correct result line with the
    metrics that the manifest lists for the cell: with the card's peaks
    given, every one but those read from the device's trace."""
    man = Manifest(root)
    card = json.loads((man.bench / "peaks.json").read_text())["cards"][0]
    monkeypatch.setattr(Manifest, "peaks", lambda self, kind: card)
    res = bench.run_cell(root, cell, 2**31 + 1, 0.3, bool(trace), "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    want = {e["name"] for e in man.metrics(cell, bool(trace))
            if e["source"] != "device_trace"}
    assert set(res["metrics"]) == want
    if trace:
        assert res["device"]["window_s"] > 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_run_result_line(tiny, monkeypatch, cell, trace):
    check_result_line(tiny, cell, trace, monkeypatch)


def test_forbidden_modules_compare_whole_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "jaxtyping", "reprox"]) == []
    assert bench.forbidden_modules(["repro", "repro.core", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def _python(code, cwd, **env):
    e = dict(os.environ, PYTHONPATH="", **env)
    return subprocess.run([sys.executable, *code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def check_loads_no_jax(root, cells):
    """Everything a run of ``cells`` loads, the harness, drivers,
    references and readers and the program, in a fresh interpreter: no
    ``jax``, ``jaxlib``, ``flax`` or ``repro`` among the modules."""
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "from oocbench.harness import bench\n"
            "for c in %r:\n"
            "    for t in (False, True):\n"
            "        r = bench.run_cell(%r, c, 3, 0.2, t, 'cpu')\n"
            "        assert r['correct'], r\n"
            "print(json.dumps(sorted(sys.modules)))\n"
            % (str(ROOT / "src"), str(ROOT), list(cells), str(root)))
    out = _python(["-c", code], root)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in mods and "oocbench.harness.bench" in mods
    assert bench.forbidden_modules(mods) == []


def test_a_run_loads_neither_jax_nor_the_reference(tiny):
    check_loads_no_jax(tiny, CELLS)


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    cell = CELLS[0]
    args = ["oocbench/run.py", "--workload", cell, "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    out = _python(args, ROOT)
    if not torch.cuda.is_available():
        assert out.returncode == 2 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "oocbench", tmp_path / "oocbench")
    out = _python(args, tmp_path)
    assert out.returncode != 0 and out.stdout == ""
