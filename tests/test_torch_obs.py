"""The port's observability layer against the reference (CPU).

Twins of the ``tests/test_obs.py`` tests that had none: the metric
registry (labels, the disabled guard, gauges and histograms, the
Prometheus golden, the snapshot round trip, escaping, unknown types), the
tracer, drift staleness, the executor's span reset and disabled-obs
silence, the facade, the snapshot shape; each compared with the
reference's output where both produce one.  Then the tools: the
``export_trace`` smoke (``sim`` and ``exec --cpu``), the ``run_report``
renderer and sidecar merge, ``run_report --cpu --check``, and the
``observed_gemm`` example with ``--cpu``.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

import repro.obs as RO
from repro_torch.core import ScheduleExecutor, build_gemm_schedule
from repro_torch.core import plan_gemm_partition
from repro_torch.core.api import hclObservability
from repro_torch.obs import (DriftMonitor, MetricRegistry, Observability,
                             Tracer, get_observability)
from repro_torch.scripts.run_report import merge_snapshots, render_markdown

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _clean_obs():
    obs = get_observability()
    obs.reset()
    obs.disable()
    yield obs
    obs.reset()
    obs.disable()


# ------------------------------------------------------------------ metrics
def test_counter_labels_and_disabled_guard():
    reg = MetricRegistry(enabled=True)
    c = reg.counter("repro_test_total", "help text")
    c.inc(kernel="gemm")
    c.inc(2, kernel="gemm")
    c.inc(kernel="syrk")
    assert c.value(kernel="gemm") == 3
    assert c.value(kernel="syrk") == 1
    assert c.value(kernel="absent") == 0
    with pytest.raises(ValueError):
        c.inc(-1, kernel="gemm")
    reg.enabled = False
    c.inc(100, kernel="gemm")
    assert c.value(kernel="gemm") == 3


def test_gauge_set_add_and_histogram_stats():
    reg = MetricRegistry(enabled=True)
    g = reg.gauge("repro_test_gauge")
    g.set(2.5, tier="HBM")
    g.add(0.5, tier="HBM")
    assert g.value(tier="HBM") == 3.0
    h = reg.histogram("repro_test_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    s, n = h.stats()
    assert n == 4 and s == pytest.approx(55.55)


def test_redeclaring_name_as_other_type_raises():
    reg = MetricRegistry(enabled=True)
    reg.counter("repro_test_total")
    reg.counter("repro_test_total")
    with pytest.raises(TypeError):
        reg.gauge("repro_test_total")


def _filled(mod):
    reg = mod.MetricRegistry(enabled=True)
    reg.counter("repro_a_total", "a").inc(3, kernel="gemm")
    reg.gauge("repro_b_ratio", "b").set(1.5, tier="HBM")
    h = reg.histogram("repro_c_seconds", "c", buckets=(0.1, 1.0))
    h.observe(0.05, kernel="lu")
    h.observe(7.0, kernel="lu")
    return reg


def test_snapshot_round_trips_through_from_snapshot():
    reg = _filled(sys.modules["repro_torch.obs"])
    snap = reg.snapshot()
    clone = MetricRegistry.from_snapshot(snap)
    assert clone.to_prometheus_text() == reg.to_prometheus_text()
    assert json.loads(json.dumps(snap)) == snap
    # the reference reads the port's snapshot and writes the same text
    ref = RO.MetricRegistry.from_snapshot(snap)
    assert ref.to_prometheus_text() == reg.to_prometheus_text()
    assert _filled(RO).snapshot() == snap


GOLDEN = (
    "# HELP repro_run_seconds wall\n"
    "# TYPE repro_run_seconds histogram\n"
    'repro_run_seconds_bucket{kernel="gemm",le="0.5"} 1\n'
    'repro_run_seconds_bucket{kernel="gemm",le="5.0"} 2\n'
    'repro_run_seconds_bucket{kernel="gemm",le="+Inf"} 2\n'
    'repro_run_seconds_sum{kernel="gemm"} 2.75\n'
    'repro_run_seconds_count{kernel="gemm"} 2\n'
    "# HELP repro_runs_total runs\n"
    "# TYPE repro_runs_total counter\n"
    'repro_runs_total{kernel="gemm"} 2\n')


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_prometheus_exposition_golden(pkg):
    mod = RO if pkg == "ref" else sys.modules["repro_torch.obs"]
    reg = mod.MetricRegistry(enabled=True)
    reg.counter("repro_runs_total", "runs").inc(2, kernel="gemm")
    h = reg.histogram("repro_run_seconds", "wall", buckets=(0.5, 5.0))
    h.observe(0.25, kernel="gemm")
    h.observe(2.5, kernel="gemm")
    assert reg.to_prometheus_text() == GOLDEN


def test_prometheus_empty_histogram_family():
    reg = MetricRegistry(enabled=True)
    reg.histogram("repro_test_seconds", "help text")
    text = reg.to_prometheus_text()
    assert "# HELP repro_test_seconds help text" in text
    assert "# TYPE repro_test_seconds histogram" in text
    assert "repro_test_seconds_bucket" not in text
    back = MetricRegistry.from_snapshot(reg.snapshot())
    assert back.to_prometheus_text() == text


def test_prometheus_label_values_escaped():
    reg = MetricRegistry(enabled=True)
    reg.counter("repro_test_total").inc(
        tag='S(a[0]) "quoted" back\\slash', note="line1\nline2")
    text = reg.to_prometheus_text()
    assert 'tag="S(a[0]) \\"quoted\\" back\\\\slash"' in text
    assert 'note="line1\\nline2"' in text
    labels = reg.snapshot()["metrics"][0]["samples"][0]["labels"]
    assert labels["tag"] == 'S(a[0]) "quoted" back\\slash'


def test_from_snapshot_unknown_metric_type():
    snap = {"metrics": [{"name": "repro_x", "type": "summary",
                         "samples": []}]}
    with pytest.raises(ValueError, match="unknown metric type 'summary'"):
        MetricRegistry.from_snapshot(snap)


# ------------------------------------------------------------------- tracer
def test_tracer_nests_spans_and_absorbs_flat_groups():
    t = [0.0]
    tr = Tracer("test", clock=lambda: t[0])
    with tr.span("outer", cat="tune"):
        t[0] = 1.0
        with tr.span("inner", cat="tune") as sp:
            sp.annotate(from_cache=False)
            t[0] = 2.0
    spans = tr.spans()
    outer = next(s for s in spans if s.name == "outer")
    inner = next(s for s in spans if s.name == "inner")
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert dict(inner.args)["from_cache"] == "False"
    tr.add_flat_spans("gpu0", [("h2d A[0]", 0, 0.0, 0.5)], offset=1.0)
    tr.add_flat_spans("phi0", [("compute C[0]", 1, 0.0, 0.2)], offset=1.0)
    doc = tr.to_chrome_trace()
    assert sorted({e["pid"] for e in doc["traceEvents"]}) == [0, 1, 2]
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"test", "gpu0", "phi0"} <= names
    summ = tr.summary()
    assert summ["control_spans"] == 2
    assert summ["groups"]["gpu0"]["spans"] == 1
    assert summ["groups"]["phi0"]["span_seconds"] == pytest.approx(0.2)


# -------------------------------------------------------------------- drift
def test_stale_flags_trend_not_constant_scale():
    mon = DriftMonitor(window=8)
    for _ in range(4):
        mon.record("gemm", "HBM", "fp",
                   predicted_makespan=1.0, measured_seconds=50.0)
    assert mon.stale(threshold=1.25) == []
    for _ in range(8):
        mon.record("lu", "HBM", "fp",
                   predicted_makespan=1.0, measured_seconds=1.0)
        mon.record("lu", "HBM", "fp",
                   predicted_makespan=1.0, measured_seconds=3.0)
    assert [k for k, _ in mon.stale(threshold=1.25)] == [("lu", "HBM", "fp")]


def test_stale_single_observation_never_flagged():
    mon = DriftMonitor(window=8)
    for _ in range(2):
        mon.record("gemm", "HBM", "fp",
                   predicted_makespan=1.0, measured_seconds=500.0)
        assert mon.stale(threshold=1.25) == []


def test_stale_baseline_survives_window_roll():
    mons = [DriftMonitor(window=4), RO.DriftMonitor(window=4)]
    for mon in mons:
        mon.record("lu", "HBM", "fp",
                   predicted_makespan=1.0, measured_seconds=1.0)
        for ratio in (1.2, 1.5, 1.8, 2.0, 2.0, 2.0, 2.0):
            mon.record("lu", "HBM", "fp",
                       predicted_makespan=1.0, measured_seconds=ratio)
    mon = mons[0]
    assert ("lu", "HBM", "fp") in [k for k, _ in mon.stale(threshold=1.25)]
    assert mon.snapshot()["rolling"]["lu|HBM|fp"]["first_time_ratio"] == 1.0
    assert mon.snapshot()["rolling"] == mons[1].snapshot()["rolling"]


# ------------------------------------------------------ executor and obs
def _seeded_gemm(m=256, n=256, k=128):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, n)).astype(np.float32)
    C = np.zeros((m, n), dtype=np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 3
    part = plan_gemm_partition(m, n, k, budget, 4)
    return A, B, C, build_gemm_schedule(part)


def test_last_spans_reset_between_runs():
    A, B, C, sched = _seeded_gemm()
    ex = ScheduleExecutor(record_spans=True, torch_device="cpu")
    ctx = {"alpha": 1.0, "beta": 0.0}
    ex.run(sched, {"A": A, "B": B}, {"C": C.copy()}, ctx)
    assert ex.last_spans
    ex.record_spans = False
    ex.run(sched, {"A": A, "B": B}, {"C": C.copy()}, ctx)
    assert ex.last_spans == []


def test_disabled_obs_records_nothing():
    obs = get_observability()
    A, B, C, sched = _seeded_gemm()
    ScheduleExecutor(torch_device="cpu").run(
        sched, {"A": A, "B": B}, {"C": C}, {"alpha": 1.0, "beta": 0.0})
    assert obs.metrics.snapshot()["metrics"] == []
    assert obs.drift.records() == []


def test_hcl_facade_returns_enabled_singleton():
    obs = hclObservability(enable=True, trace=True, trace_name="facade")
    assert obs is get_observability()
    assert obs.metrics.enabled and obs.tracer is not None
    assert obs.tracer.name == "facade"
    assert hclObservability() is obs
    assert obs.metrics.enabled


def test_observability_snapshot_shape():
    snaps = []
    for mod in (sys.modules["repro_torch.obs"], RO):
        obs = mod.Observability()
        obs.enable(metrics=True, trace=True)
        obs.metrics.counter("repro_x_total").inc()
        obs.record_drift("gemm", "HBM", "fp",
                         predicted_makespan=1.0, measured_seconds=2.0)
        with obs.span("phase"):
            pass
        snaps.append(obs.snapshot())
    snap = snaps[0]
    assert {f["name"] for f in snap["metrics"]} >= {
        "repro_x_total", "repro_drift_records_total",
        "repro_drift_time_ratio", "repro_drift_byte_ratio"}
    assert snap["drift"]["rolling"]["gemm|HBM|fp"]["last_time_ratio"] == 2.0
    assert snap["trace"]["control_spans"] == 1
    assert json.loads(json.dumps(snap)) == snap
    # the trace summary carries wall-clock seconds; the rest is equal
    for s in snaps:
        del s["trace"]
        for r in s["drift"]["records"]:
            r.pop("timestamp", None)
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------- the tools
def _run(args, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, cwd=ROOT, timeout=timeout, env=ENV)


@pytest.mark.parametrize("mode", ["sim", "exec"])
def test_export_trace_stdout_summary_smoke(mode):
    res = _run(["repro_torch.scripts.export_trace", "--mode", mode,
                "--M", "256", "--N", "256", "--K", "128", "--budget-mb",
                "0.5", "--out", "-", "--summary"]
               + (["--cpu"] if mode == "exec" else []))
    assert res.returncode == 0, res.stderr
    doc = json.loads(res.stdout)
    assert doc["traceEvents"]
    assert doc["otherData"]["h2d_bytes"] > 0
    assert "stream utilization" in doc["otherData"]["analysis"]
    assert "summary:" in res.stderr and "pid 0" in res.stderr
    if mode == "exec":
        assert "concurrent on cpu" in res.stderr


def test_run_report_renders_snapshot_markdown():
    obs = Observability()
    obs.enable(metrics=True)
    obs.metrics.counter("repro_executor_runs_total").inc(kernel="gemm")
    obs.record_drift("gemm", "HBM", "fp", predicted_makespan=1.0,
                     measured_seconds=2.0, predicted_h2d_bytes=10,
                     measured_h2d_bytes=10)
    md = render_markdown(obs.snapshot())
    assert "`repro_executor_runs_total`" in md
    assert "`gemm|HBM|fp`" in md and "| 1 |" in md


def test_run_report_merges_sidecar_directory(tmp_path):
    def sidecar(name, runs, gauge, wall):
        obs = Observability()
        obs.enable(metrics=True)
        for _ in range(runs):
            obs.metrics.counter("repro_executor_runs_total",
                                "runs").inc(kernel="gemm")
        obs.metrics.gauge("repro_drift_time_ratio").set(gauge, kernel="gemm")
        obs.metrics.histogram("repro_executor_run_seconds").observe(
            wall, kernel="gemm")
        obs.record_drift("gemm", "HBM", "fp", predicted_makespan=1.0,
                         measured_seconds=wall, predicted_h2d_bytes=8,
                         measured_h2d_bytes=8)
        path = tmp_path / f"{name}.metrics.json"
        path.write_text(json.dumps(obs.snapshot()))
        return path

    a = sidecar("a", runs=2, gauge=1.5, wall=0.25)
    b = sidecar("b", runs=3, gauge=2.5, wall=0.75)
    snap = merge_snapshots([a, b])
    fams = {f["name"]: f for f in snap["metrics"]}
    assert fams["repro_executor_runs_total"]["samples"][0]["value"] == 5
    assert fams["repro_drift_time_ratio"]["samples"][0]["value"] == 2.5
    h = fams["repro_executor_run_seconds"]["samples"][0]
    assert h["count"] == 2 and h["sum"] == pytest.approx(1.0)
    assert len(snap["drift"]["records"]) == 2
    roll = snap["drift"]["rolling"]["gemm|HBM|fp"]
    assert roll["n"] == 2 and roll["first_time_ratio"] == 0.25
    md = render_markdown(snap)
    assert "## Sources" in md and str(a) in md
    # the command line reads the directory and renders the same report
    res = _run(["repro_torch.scripts.run_report", "--input", str(tmp_path)])
    assert res.returncode == 0, res.stderr
    assert res.stdout == md


def test_run_report_demo_and_checks_on_cpu(tmp_path):
    """The demo on the host with the canned-verdict checks: exit 0, the
    attribution sections, and the plan-level documents (analysis, what-if,
    hybrid attribution) equal to the reference's demo."""
    out = tmp_path / "snap.json"
    res = _run(["repro_torch.scripts.run_report", "--cpu", "--check",
                "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "analyze checks passed" in res.stdout
    for head in ("## Attribution", "## What-if sensitivity",
                 "## Hybrid device attribution"):
        assert head in res.stdout
    snap = json.loads(out.read_text())
    assert snap["demo"]["max_abs_err"] < 1e-3
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "run_report.py"),
         "--format", "json"], capture_output=True, text=True, cwd=ROOT,
        timeout=240, env={**ENV, "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr
    rsnap = json.loads(ref.stdout)
    for key in ("analysis", "whatif", "hybrid_analysis"):
        assert snap[key] == rsnap[key], key


def test_observed_gemm_example_runs_on_cpu():
    res = _run(["repro_torch.examples.observed_gemm", "--cpu"])
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "observed gemm OK"
    assert "byte ratios: all exactly 1.0" in res.stdout
    assert any(line.startswith("  what-if ") for line in lines)
    assert any("critical path" in line for line in lines)


# ------------------------------------------------- entry-point call records
def _spd(n=192, seed=3):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _call(entry, ex, tmp_path=None):
    """One out-of-core call of ``entry`` on executor ``ex`` (CPU); the
    tuned GEMM plans through a fresh tuner under ``tmp_path``,
    ``gemm-with-c`` adds the caller's C at β = 1, and ``gemm-in-core``
    is the same GEMM under a budget that holds it (its zeros made on the
    host, no executor run)."""
    from repro_torch.core import Device, HostOocRuntime, ooc_cholesky, \
        ooc_gemm

    if entry == "cholesky":
        A = _spd()
        return ooc_cholesky(A, panel=64, budget_bytes=A.nbytes // 2,
                            executor=ex)
    A, B, C, _ = _seeded_gemm()
    budget = (A.nbytes + B.nbytes + A.shape[0] * B.shape[1] * 4) // 3
    if entry == "gemm-in-core":
        budget = 1 << 30
    kw = {}
    if entry == "gemm-with-c":
        kw = dict(C=C, beta=1.0)
    if entry == "gemm-tuned":
        from repro_torch.tune import AutoTuner, PlanCache, gpu_profile
        kw = dict(tune="auto", tuner=AutoTuner(
            profile=gpu_profile(), cache=PlanCache(str(tmp_path / "p.json")),
            torch_device="cpu", nbuf_options=(1, 2), max_steps=128))
    return ooc_gemm(A, B, budget_bytes=budget,
                    runtime=HostOocRuntime(Device("HBM", 0, budget),
                                           executor=ex), **kw)


# entry -> (its spans, bytes its host copies write, bytes its runs fill on
# the device): a no-C GEMM makes C's blocks on the device, not on the host
CALL_SPANS = {
    "gemm": ({"gemm.intake", "gemm.plan", "gemm.execute"}, 0,
             256 * 256 * 4),
    "gemm-tuned": ({"gemm.intake", "gemm.plan", "gemm.execute",
                    "gemm.drift"}, 0, 256 * 256 * 4),
    "gemm-with-c": ({"gemm.intake", "gemm.plan", "gemm.clone_c",
                     "gemm.execute"}, 256 * 256 * 4, 0),
    "cholesky": ({"cholesky.intake", "cholesky.plan", "cholesky.clone_a",
                  "cholesky.execute", "cholesky.tril"},
                 192 * 192 * 4 + 192 * 191 // 2 * 4, 0),
}


@pytest.mark.parametrize("entry", sorted(CALL_SPANS))
def test_entry_point_call_appends_one_record(entry, tmp_path):
    """An executor that records spans makes each call append one completed
    record: the table's spans, the executor's wall, the copies' bytes, the
    bytes filled on the device, and the entry point's own spans within the
    call's own seconds."""
    obs = get_observability()
    ex = ScheduleExecutor(record_spans=True, torch_device="cpu")
    _call(entry, ex, tmp_path)
    (rec,) = obs.calls
    names, copied, filled = CALL_SPANS[entry]
    assert rec.ok and rec.entry == entry.split("-")[0]
    assert {k for k in rec.seconds
            if k.startswith(rec.entry + ".")} == names
    assert rec.exec_walls == [ex.last_wall_seconds]
    assert rec.seconds["executor.land"] == ex.last_land_seconds > 0
    assert rec.copy_bytes == copied
    assert rec.fill_bytes == ex.last_fill_bytes == filled
    assert 0 < sum(rec.seconds[k] for k in names) <= rec.seconds[rec.entry]
    assert "calls" not in json.dumps(obs.snapshot())


@pytest.mark.parametrize("locked", [False, True])
def test_attention_call_appends_one_record(monkeypatch, locked):
    """Each ``ooc_attention`` call on an executor that records spans
    appends one completed ``attention`` record: its four spans within the
    call's own seconds, its executor's wall, and the run's direct H2D bytes
    (all of them for operands taken as page-locked, none for pageable
    ones)."""
    from repro_torch.core import ooc_attention, runtime

    monkeypatch.setattr(runtime, "_page_locked", lambda t: locked)
    g = np.random.default_rng(5)
    q = g.standard_normal((8, 64)).astype(np.float32)
    K, V = (g.standard_normal((1000, 2, 64)).astype(np.float32)
            for _ in range(2))
    obs = get_observability()
    ex = ScheduleExecutor(record_spans=True, torch_device="cpu")
    walls = []
    for _ in range(2):
        ooc_attention(q, K, V, budget_bytes=K.nbytes, executor=ex)
        walls.append(ex.last_wall_seconds)
    assert len(obs.calls) == 2
    names = {"attention.intake", "attention.plan", "attention.execute",
             "attention.out"}
    for rec, wall in zip(obs.calls, walls):
        assert rec.ok and rec.entry == "attention"
        assert {k for k in rec.seconds if k.startswith("attention.")} \
            == names
        assert rec.exec_walls == [wall]
        assert rec.direct_h2d_bytes == ex.last_direct_h2d_bytes \
            == (ex.last_h2d_bytes if locked else 0)
        assert 0 < sum(rec.seconds[k] for k in names) \
            <= rec.seconds["attention"]
    assert ex.last_h2d_bytes > 0


def test_nothing_recorded_when_tracing_is_off(monkeypatch):
    """No record, no ``record_function``, and the shared no-op span, when
    neither the executor records spans nor a tracer nor a profiler is
    on."""
    import torch.autograd.profiler as ap

    from repro_torch.obs import _NULL_SPAN

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(ap, "record_function", refuse)
    obs = get_observability()
    ex = ScheduleExecutor(torch_device="cpu")
    for entry in ("gemm", "cholesky"):
        _call(entry, ex)
    assert len(obs.calls) == 0
    assert ex.last_land_seconds > 0
    assert obs.span("gemm.plan") is _NULL_SPAN
    assert obs.call("gemm", False) is _NULL_SPAN


def test_profiler_sees_spans_around_their_operators():
    """Under ``torch.profiler`` the spans are ``record_function`` ranges:
    each landing of the out-of-core call is an ``executor.land``, and the
    in-core call's ``gemm.zero_c`` (the one GEMM that still zero-fills C
    on the host) encloses the zero-fill's ``aten::zeros`` and
    ``aten::fill_``."""
    import torch

    ex = ScheduleExecutor(torch_device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _call("gemm", ex)
        _call("gemm-in-core", ex)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    (zero,) = [e for e in events if e[0] == "gemm.zero_c"]
    inside = {n for n, s, t in events if zero[1] <= s and t <= zero[2]}
    assert {"aten::zeros", "aten::fill_"} <= inside
    names = [n for n, _, _ in events]
    assert names.count("gemm") == 2
    assert names.count("executor.land") > 0
    assert len(get_observability().calls) == 0


def test_tracer_nests_entry_spans_under_the_call():
    """Each call's entry spans are children of its call span; the in-core
    call's ``gemm.zero_c`` carries its copy's bytes."""
    obs = get_observability()
    tr = obs.start_trace("calls")
    _call("gemm", ScheduleExecutor(torch_device="cpu"))
    _call("gemm-in-core", ScheduleExecutor(torch_device="cpu"))
    spans = tr.spans()
    ooc, in_core = [s for s in spans if s.name == "gemm"]
    inner = [s for s in spans if s.name.startswith("gemm.")
             and s.parent_id == ooc.span_id]
    assert {s.name for s in inner} == CALL_SPANS["gemm"][0]
    zero = [s for s in spans if s.name == "gemm.zero_c"]
    assert [s.parent_id for s in zero] == [in_core.span_id]
    assert dict(zero[0].args)["copy_bytes"] == str(256 * 256 * 4)
    assert {s.parent_id for s in spans if s.name.startswith("gemm.")} \
        == {ooc.span_id, in_core.span_id}
    assert [(r.ok, r.entry) for r in obs.calls] == [(True, "gemm")] * 2


def test_land_seconds_reset_between_runs(monkeypatch):
    from repro_torch.core import runtime

    A, B, C, sched = _seeded_gemm()
    ex = ScheduleExecutor(torch_device="cpu")
    ctx = {"alpha": 1.0, "beta": 0.0}
    land = runtime._land
    n_d2h = sum(op.kind.name == "D2H" for op in sched.ops)

    def slow_land(*a):
        time.sleep(0.02)
        land(*a)

    monkeypatch.setattr(runtime, "_land", slow_land)
    ex.run(sched, {"A": A, "B": B}, {"C": C.copy()}, ctx)
    assert ex.last_land_seconds >= 0.02 * n_d2h > 0
    monkeypatch.setattr(runtime, "_land", land)
    ex.run(sched, {"A": A, "B": B}, {"C": C.copy()}, ctx)
    assert 0 < ex.last_land_seconds < 0.02 * n_d2h


@pytest.mark.parametrize("case", ["cholesky-loop", "gemm-oom-rerun",
                                  "gemm-raises"])
def test_one_record_per_outer_call(case):
    """A nested entry call (the Cholesky loop's ``ooc_syrk``) is a span of
    the outer record, a degraded re-run joins the call's record, and a
    call that raises leaves a failed record."""
    from repro_torch.core import Device, HostOocRuntime, ooc_cholesky, \
        ooc_gemm
    from repro_torch.fault import FaultPlan, FaultPolicy, FaultSpec

    obs = get_observability()
    ex = ScheduleExecutor(record_spans=True, torch_device="cpu")
    if case == "cholesky-loop":
        obs.start_trace("loop")
        A = _spd()
        ooc_cholesky(A, panel=64, budget_bytes=A.nbytes // 2,
                     backend="vmem", torch_device="cpu")
        (rec,) = obs.calls
        assert rec.ok and rec.entry == "cholesky" and "syrk" in rec.seconds
        return
    A, B, _, sched = _seeded_gemm()
    rt = HostOocRuntime(Device("HBM", 0, 1 << 30), executor=ex)
    budget = (A.nbytes + B.nbytes + A.shape[0] * B.shape[1] * 4) // 3
    if case == "gemm-raises":
        with pytest.raises(ValueError):
            ooc_gemm(A, B.T, budget_bytes=budget, runtime=rt)
        (rec,) = obs.calls
        assert not rec.ok and rec.exec_walls == []
        return
    first = next(i for i, op in enumerate(sched.ops)
                 if op.kind.name == "COMPUTE")
    pol = FaultPolicy(sleep=lambda s: None)
    ooc_gemm(A, B, budget_bytes=budget, runtime=rt, fault_policy=pol,
             faults=FaultPlan(specs=(FaultSpec(op=first, cls="oom"),)))
    assert pol.degrades
    (rec,) = obs.calls
    assert rec.ok and rec.exec_walls == [ex.last_wall_seconds]
