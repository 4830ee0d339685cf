"""Bottleneck attribution and what-if analysis in the port, against the
reference (CPU).

Twins of ``tests/test_analyze.py``, with its parameters, on the port's
own planner, simulator and canned profiles; then equality with the
reference on the same problems, floats exact (both sides place ops
through simulators that agree): ``TraceAnalysis.to_json`` key for key on
GEMM, SYRK, Cholesky with lookahead and the gpu+phi pair,
``WhatIfReport`` scenarios and ranking, ``HybridAnalysis.to_json()``, the
published ``repro_analysis_*`` metrics, and ``from_spans`` over the
port's CPU executor spans in both executor modes.
"""

import types

import numpy as np
import pytest

import repro.core.partitioner as r_part
import repro.core.pipeline as r_pipe
import repro.hybrid as RH
import repro.hybrid.executor as RHE
import repro.obs as RO
import repro.obs.analyze as r_ana
import repro.obs.whatif as r_wif
import repro.tune as RT
import repro_torch.core.partitioner as t_part
import repro_torch.core.pipeline as t_pipe
import repro_torch.hybrid as TH
import repro_torch.hybrid.executor as THE
import repro_torch.obs as TO
import repro_torch.obs.analyze as t_ana
import repro_torch.obs.whatif as t_wif
import repro_torch.tune as TT
from repro_torch.core import ScheduleExecutor
from repro_torch.core.simulator import simulate
from repro_torch.obs import get_observability
from repro_torch.obs.analyze import TraceAnalysis, analyze_plan
from repro_torch.obs.whatif import whatif_gemm
from repro_torch.tune import gpu_profile, phi_profile

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def _pkg(part, pipe, ana, wif, tune, hyb, hexe, obs):
    return types.SimpleNamespace(
        plan_gemm_partition=part.plan_gemm_partition,
        gemm_pipeline_spec=pipe.gemm_pipeline_spec,
        syrk_pipeline_spec=pipe.syrk_pipeline_spec,
        compile_pipeline=pipe.compile_pipeline,
        factor_pipeline_spec=pipe.factor_pipeline_spec,
        compile_factor_pipeline=pipe.compile_factor_pipeline,
        schedule_stats=pipe.schedule_stats,
        TraceAnalysis=ana.TraceAnalysis, analyze_plan=ana.analyze_plan,
        whatif_gemm=wif.whatif_gemm, whatif_plan=wif.whatif_plan,
        gpu_profile=tune.gpu_profile, phi_profile=tune.phi_profile,
        AutoTuner=tune.AutoTuner, DeviceSpec=hyb.DeviceSpec,
        plan_hybrid_gemm=hyb.plan_hybrid_gemm,
        simulate_hybrid=hexe.simulate_hybrid,
        analyze_hybrid=hexe.analyze_hybrid, obs=obs)


REF = _pkg(r_part, r_pipe, r_ana, r_wif, RT, RH, RHE, RO)
PORT = _pkg(t_part, t_pipe, t_ana, t_wif, TT, TH, THE, TO)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Both packages' singletons disabled and empty around every test."""
    for pkg in (REF, PORT):
        pkg.obs.get_observability().reset().disable()
    yield get_observability()
    for pkg in (REF, PORT):
        pkg.obs.get_observability().reset().disable()


def _gemm_sched(m=1024, bpe=4, ns=2, nb=2, budget=None, kernel="gemm",
                pkg=PORT):
    budget = budget if budget is not None else (3 * m * m * bpe) // 2
    part = pkg.plan_gemm_partition(m, m, m, budget, bpe, nbuf=nb,
                                   nstreams=ns)
    if kernel == "gemm":
        spec = pkg.gemm_pipeline_spec(part, band=nb)
    else:
        spec = pkg.syrk_pipeline_spec(part, band=nb)
    return pkg.compile_pipeline(spec, nstreams=ns, nbuf=nb)


def _chol_sched(pkg=PORT):
    n, panel = 2048, 256
    budget = (3 * panel * n * 4) * 2
    spec = pkg.factor_pipeline_spec(n, panel, budget, 4, kind="cholesky",
                                    lookahead=1, nbuf=2)
    return pkg.compile_factor_pipeline(spec, nstreams=2, nbuf=2)


HYB_M = 1024


@pytest.fixture(scope="module")
def hybrid_plans():
    """The gpu+phi pair's plan at m = 1024, from each package's planner."""
    budget = (3 * HYB_M * HYB_M * 4) // 2
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        devs = [pkg.DeviceSpec("gpu0", pkg.gpu_profile(), budget),
                pkg.DeviceSpec("phi0", pkg.phi_profile(), budget)]
        out[name] = pkg.plan_hybrid_gemm(HYB_M, HYB_M, HYB_M, devs,
                                         dtype="float32")
    return out


# ---------------------------------------------------------------- exactness
@pytest.mark.parametrize("profile,ns", [(gpu_profile, 2), (phi_profile, 1)])
def test_reconciliation_exact_gemm(profile, ns):
    sched = _gemm_sched(ns=ns)
    hw = profile().model_for(ns)
    ana, res = TraceAnalysis.analyze(sched, hw)
    out = ana.verify_reconciliation(res, stats=t_pipe.schedule_stats(sched))
    assert out["critical_path_seconds"] == pytest.approx(res.makespan)
    assert ana.exact and ana.source == "sim"
    assert all(seg.cls in ("h2d", "d2h", "compute", "merge",
                           "eviction-stall") for seg in ana.path)


def test_reconciliation_exact_syrk():
    sched = _gemm_sched(kernel="syrk")
    ana, res = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    ana.verify_reconciliation(res, stats=t_pipe.schedule_stats(sched))


def test_reconciliation_exact_cholesky_lookahead():
    sched = _chol_sched()
    ana, res = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    ana.verify_reconciliation(res, stats=t_pipe.schedule_stats(sched))


def test_reconciliation_exact_hybrid_pair(hybrid_plans):
    hplan = hybrid_plans["port"]
    sim = THE.simulate_hybrid(hplan)
    ha = THE.analyze_hybrid(hplan, sim)
    assert ha.makespan == sim.makespan
    assert ha.critical_device in ("gpu0", "phi0")
    assert 0.0 <= ha.imbalance < 1.0
    for name, ana in ha.per_device:
        ana.verify_reconciliation(dict(sim.per_device)[name])
    assert ha.device(ha.critical_device).makespan == sim.makespan


# ----------------------------------------------------------------- verdicts
def test_verdict_transfer_bound_phi_one_stream():
    m = 256
    sched = _gemm_sched(m=m, ns=1, nb=1, budget=(m * m * 4 * 3) // 2)
    ana, res = TraceAnalysis.analyze(sched, phi_profile().model_for(1))
    ana.verify_reconciliation(res)
    assert ana.verdict == "transfer-bound"
    assert ana.shares["h2d"] + ana.shares.get("d2h", 0.0) >= 0.5


def test_verdict_compute_bound_gpu_large():
    m = 8192
    sched = _gemm_sched(m=m, bpe=8, ns=2, nb=2, budget=(3 * m * m * 8) // 2)
    ana, res = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    ana.verify_reconciliation(res)
    assert ana.verdict == "compute-bound"
    assert ana.shares["compute"] >= 0.5


def test_eviction_stalls_surface_when_buffers_scarce():
    sched = _gemm_sched(ns=2, nb=1)
    ana, res = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    ana.verify_reconciliation(res)
    stalls = [seg for seg in ana.path if seg.cls == "eviction-stall"]
    assert stalls, "expected eviction-stall segments at nbuf=1"
    assert all("holding" in seg.detail for seg in stalls)


def test_stream_utilization_and_gaps_account_for_makespan():
    sched = _gemm_sched()
    ana, _ = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    for st in ana.streams:
        assert st.busy_seconds + st.idle_seconds == \
            pytest.approx(ana.makespan)
        assert 0.0 < st.utilization <= 1.0
    assert ana.stream_utilization().keys() == {0, 1}
    for g in ana.top_gaps(10):
        assert g.duration > 0 and g.cause


# ---------------------------------------------------- measured span input
def _executed(mode, m=256):
    """A 2-stream GEMM run on the port's CPU executor with spans recorded:
    (schedule, spans)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, m)).astype(np.float32)
    B = rng.standard_normal((m, m)).astype(np.float32)
    C = np.zeros((m, m), dtype=np.float32)
    sched = _gemm_sched(m=m, budget=(3 * m * m * 4) // 2)
    ex = ScheduleExecutor(record_spans=True, mode=mode, torch_device="cpu")
    ex.run(sched, {"A": A, "B": B}, {"C": C}, {"alpha": 1.0, "beta": 0.0})
    return sched, ex.last_spans


def test_from_spans_wall_clock_is_tolerant():
    sched, spans = _executed("issue_order")
    ana = TraceAnalysis.from_spans(sched, spans)
    assert not ana.exact and ana.source == "spans"
    assert ana.path[-1].end == ana.makespan
    for a, b in zip(ana.path, ana.path[1:]):
        assert a.end == b.start
    assert ana.verdict in ("transfer-bound", "compute-bound",
                           "dependency-bound")


def test_exact_mode_rejects_wall_spans():
    sched = _gemm_sched(m=256, budget=(3 * 256 * 256 * 4) // 2)
    res = simulate(sched, gpu_profile().model_for(2))
    jittered = [(tag, s, st + 1e-7, en + 2e-7)
                for (tag, s, st, en) in res.op_spans]
    with pytest.raises(RuntimeError, match="no exact predecessor"):
        TraceAnalysis(sched, jittered, tolerance=0.0)


def test_span_schedule_mismatch_raises():
    sched = _gemm_sched(m=256, budget=(3 * 256 * 256 * 4) // 2)
    res = simulate(sched, gpu_profile().model_for(2))
    with pytest.raises(ValueError, match="do not describe the same run"):
        TraceAnalysis(sched, res.op_spans[:-1])
    bad = [(tag + "?", s, st, en) for (tag, s, st, en) in res.op_spans]
    with pytest.raises(ValueError, match="tag"):
        TraceAnalysis(sched, bad)


# ------------------------------------------------------------------ what-if
def _c5_whatif(profile, pkg=PORT):
    m = 8192
    budget = (3 * m * m * 8) // 6
    return pkg.whatif_gemm(m, m, m, budget, profile, dtype="float64",
                           nstreams=1, nbuf=2)


def test_whatif_gpu_second_stream_beats_bandwidth():
    rep = _c5_whatif(gpu_profile())
    plus = rep.scenario("+1 stream")
    bw = rep.scenario("bandwidth x1.25")
    assert plus.feasible and bw.feasible
    assert plus.gain_seconds > bw.gain_seconds > 0
    assert rep.best(knobs=("bandwidth", "streams", "buffers")).name \
        == "+1 stream"


def test_whatif_phi_bandwidth_wins_streams_lose():
    rep = _c5_whatif(phi_profile())
    assert rep.scenario("+1 stream").gain_seconds < 0
    assert rep.best(knobs=("bandwidth", "streams", "buffers")).name \
        == "bandwidth x1.25"
    assert rep.scenario("bandwidth x1.25").gain_seconds > 0


def test_whatif_report_shape_and_ranking():
    m = 512
    rep = whatif_gemm(m, m, m, (3 * m * m * 4) // 2, gpu_profile(),
                      nstreams=2, nbuf=2)
    assert rep.baseline.makespan > 0
    names = {s.name for s in rep.scenarios}
    assert {"baseline", "bandwidth x1.25", "flops x1.25",
            "+1 stream", "-1 stream", "+1 buffer", "-1 buffer"} <= names
    ranked = rep.ranked()
    assert all(a.gain_seconds >= b.gain_seconds
               for a, b in zip(ranked, ranked[1:]))
    assert rep.to_json()["ranked"][0] == ranked[0].name


def test_whatif_infeasible_scenarios_are_reported_not_raised():
    m = 256
    rep = whatif_gemm(m, m, m, 290000, gpu_profile(), nstreams=1, nbuf=1)
    assert rep.baseline.makespan > 0
    for s in rep.scenarios:
        if not s.feasible:
            assert s.makespan == float("inf") and s.note


# --------------------------------------------------------------- publication
def test_record_analysis_and_whatif_metrics(_clean_obs):
    obs = _clean_obs
    obs.enable(metrics=True)
    sched = _gemm_sched(m=512, budget=(3 * 512 * 512 * 4) // 2)
    ana, _ = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    obs.record_analysis(ana, kernel="gemm")
    m = obs.metrics
    assert m.get("repro_analysis_runs_total").value(kernel="gemm") == 1
    assert m.get("repro_analysis_makespan_seconds").value(
        kernel="gemm") == ana.makespan
    assert m.get("repro_analysis_verdict_info").value(
        kernel="gemm", verdict=ana.verdict) == 1
    assert m.get("repro_analysis_stream_utilization").value(
        kernel="gemm", stream="0") == ana.streams[0].utilization
    assert m.get("repro_analysis_critical_path_seconds") is not None
    rep = whatif_gemm(512, 512, 512, (3 * 512 * 512 * 4) // 2,
                      gpu_profile(), nstreams=2, nbuf=2)
    obs.record_whatif(rep, kernel="gemm")
    g = m.get("repro_analysis_whatif_gain_seconds")
    assert g.value(kernel="gemm", scenario="bandwidth x1.25") == \
        rep.scenario("bandwidth x1.25").gain_seconds


def test_analyze_hybrid_publishes_imbalance(_clean_obs, hybrid_plans):
    obs = _clean_obs
    obs.enable(metrics=True)
    ha = THE.analyze_hybrid(hybrid_plans["port"])
    g = obs.metrics.get("repro_analysis_hybrid_imbalance_ratio")
    assert g.value(kernel="gemm") == ha.imbalance
    runs = obs.metrics.get("repro_analysis_runs_total")
    assert runs.value(kernel="gemm:gpu0") == 1
    assert runs.value(kernel="gemm:phi0") == 1


# ------------------------------------------------------- plan-level helpers
def test_analyze_plan_replays_tuned_geometry(tmp_path):
    m = 512
    budget = (3 * m * m * 4) // 2
    tuner = TT.AutoTuner(profile=gpu_profile(), fingerprint="t",
                         max_steps=256, torch_device="cpu",
                         cache=TT.PlanCache(str(tmp_path / "p.json")))
    plan = tuner.gemm_plan(m, m, m, budget)
    ana, res = analyze_plan(plan, gpu_profile())
    ana.verify_reconciliation(res)
    assert res.makespan == pytest.approx(plan.makespan)


def test_hcl_facade():
    from repro_torch.core.api import hclTraceAnalysis

    sched = _gemm_sched(m=512, budget=(3 * 512 * 512 * 4) // 2)
    ana, res = hclTraceAnalysis(sched, hw=gpu_profile())
    ana.verify_reconciliation(res)
    again = hclTraceAnalysis(sched, res=res)
    assert again.makespan == ana.makespan
    with pytest.raises(ValueError, match="needs"):
        hclTraceAnalysis(sched)


def test_to_json_document_shape():
    sched = _gemm_sched(m=512, budget=(3 * 512 * 512 * 4) // 2)
    ana, _ = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    doc = ana.to_json(max_path=0)
    assert doc["exact"] is True
    assert set(doc["shares"]) <= {"h2d", "d2h", "compute", "merge",
                                  "eviction-stall", "idle-wait"}
    assert len(doc["critical_path"]) == doc["critical_path_ops"]
    assert doc["critical_path"][0]["start"] == 0.0
    assert doc["critical_path"][-1]["end"] == doc["makespan_seconds"]
    assert "streams" in doc and "top_gaps" in doc
    assert doc["n_ops"] == len(sched.ops)


# ------------------------------------------- equality with the reference
CASES = {
    "gemm-gpu": (lambda pkg: _gemm_sched(ns=2, pkg=pkg), "gpu_profile", 2),
    "gemm-phi": (lambda pkg: _gemm_sched(ns=1, pkg=pkg), "phi_profile", 1),
    "gemm-nbuf1": (lambda pkg: _gemm_sched(nb=1, pkg=pkg), "gpu_profile", 2),
    "syrk": (lambda pkg: _gemm_sched(kernel="syrk", pkg=pkg),
             "gpu_profile", 2),
    "cholesky-lookahead": (_chol_sched, "gpu_profile", 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_to_json_equals_reference(case):
    """The same problem through each package's compiler, simulator and
    analyzer: the attribution documents are equal key for key, floats
    exact, and the published metric snapshots too."""
    build, prof, ns = CASES[case]
    docs, snaps = [], []
    for pkg in (REF, PORT):
        sched = build(pkg)
        ana, res = pkg.TraceAnalysis.analyze(
            sched, getattr(pkg, prof)().model_for(ns))
        ana.verify_reconciliation(res, stats=pkg.schedule_stats(sched))
        docs.append(ana.to_json(max_path=0, max_gaps=len(ana.gaps)))
        obs = pkg.obs.Observability().enable(metrics=True)
        obs.record_analysis(ana, kernel=case)
        snaps.append(obs.snapshot())
    assert docs[0] == docs[1]
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("prof,ns,nb,m,budget,dtype", [
    ("gpu_profile", 1, 2, 8192, (3 * 8192 * 8192 * 8) // 6, "float64"),
    ("phi_profile", 1, 2, 8192, (3 * 8192 * 8192 * 8) // 6, "float64"),
    ("gpu_profile", 2, 2, 512, (3 * 512 * 512 * 4) // 2, "float32"),
    ("gpu_profile", 1, 1, 256, 290000, "float32")])
def test_whatif_equals_reference(prof, ns, nb, m, budget, dtype):
    """Scenarios (infeasible ones included) and ranking equal, and the
    ``repro_analysis_whatif_gain_seconds`` snapshot."""
    docs, snaps = [], []
    for pkg in (REF, PORT):
        rep = pkg.whatif_gemm(m, m, m, budget, getattr(pkg, prof)(),
                              dtype=dtype, nstreams=ns, nbuf=nb)
        docs.append(rep.to_json())
        obs = pkg.obs.Observability().enable(metrics=True)
        obs.record_whatif(rep, kernel="gemm")
        snaps.append(obs.snapshot())
    assert docs[0] == docs[1]
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("kernel", ["gemm", "syrk"])
def test_plan_helpers_equal_reference(kernel, tmp_path):
    """``analyze_plan`` and ``whatif_plan`` on each package's tuned plan
    for the same problem (the plans equal each other)."""
    m = 512
    budget = (3 * m * m * 4) // 2
    out = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        kw = {"torch_device": "cpu"} if pkg is PORT else {}
        tuner = pkg.AutoTuner(profile=pkg.gpu_profile(), fingerprint="t",
                              max_steps=256, nbuf_options=(1, 2),
                              cache=TT.PlanCache(str(tmp_path / name))
                              if pkg is PORT else
                              RT.PlanCache(str(tmp_path / name)), **kw)
        plan = tuner.gemm_plan(m, m, m, budget) if kernel == "gemm" \
            else tuner.syrk_plan(m, m, budget)
        ana, _ = pkg.analyze_plan(plan, pkg.gpu_profile())
        out.append((plan.to_json(), ana.to_json(),
                    pkg.whatif_plan(plan, pkg.gpu_profile()).to_json()))
    assert out[0] == out[1]


def test_hybrid_analysis_equals_reference(hybrid_plans):
    """``HybridAnalysis.to_json()`` and the metrics ``analyze_hybrid``
    publishes (one series per member plus the imbalance) are equal."""
    docs, snaps = [], []
    for name, pkg in (("ref", REF), ("port", PORT)):
        obs = pkg.obs.get_observability()
        obs.enable(metrics=True)
        docs.append(pkg.analyze_hybrid(hybrid_plans[name]).to_json())
        snaps.append(obs.snapshot())
        obs.reset().disable()
    assert docs[0] == docs[1]
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("mode", ["issue_order", "concurrent"])
def test_from_spans_places_cpu_executor_spans(mode):
    """Every op of the port's CPU executor run is placed and the byte and
    flop totals equal ``schedule_stats``, as the reference's own spans are
    (``tests/test_exec_concurrent.py``); the path tiles the timeline."""
    sched, spans = _executed(mode)
    assert len(spans) == len(sched.ops)
    ana = TraceAnalysis.from_spans(sched, spans)
    stats = t_pipe.schedule_stats(sched)
    assert ana.n_ops == len(sched.ops) == stats["n_ops"]
    assert (ana.h2d_bytes, ana.d2h_bytes, ana.flops) \
        == (stats["h2d_bytes"], stats["d2h_bytes"], stats["flops"])
    assert ana.path[0].start == ana.origin
    assert ana.path[-1].end == ana.makespan
    assert all(a.end == b.start for a, b in zip(ana.path, ana.path[1:]))
    assert sum(s.duration for s in ana.path) == \
        pytest.approx(ana.makespan - ana.origin)
    # the reference's analyzer reads the port's spans the same way
    rsched = _gemm_sched(m=256, budget=(3 * 256 * 256 * 4) // 2, pkg=REF)
    assert r_ana.TraceAnalysis.from_spans(rsched, spans).to_json() \
        == ana.to_json()


def test_a_cycling_walk_raises():
    """Two zero-length spans in one pool that end where each other start,
    with no dependency ending near them: the walk raises (the reference's
    would not end)."""
    import repro_torch.core as T

    dev = T.Device("HBM", 0, 1 << 20)
    sched = T.Schedule(dev, T.StreamFactory.create(dev, 3))
    for tag, stream in (("X", 0), ("Y", 1), ("W", 2), ("Z", 2)):
        sched.issue(T.Op(kind=T.OpKind.COMPUTE, tag=tag, stream=stream,
                         payload=T.BlockRef("noop", 0)))
    spans = [("X", 0, 5.0, 5.0), ("Y", 1, 5.0, 5.0), ("W", 2, 0.0, 1.0),
             ("Z", 2, 5.0, 10.0)]
    with pytest.raises(RuntimeError, match="cycles"):
        TraceAnalysis(sched, spans, tolerance=1e-3)
