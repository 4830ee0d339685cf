"""One-command observability report for an OOC run.

Port of ``scripts/run_report.py``.  Two modes:

  * **demo** (default) — run the acceptance scenario end to end with the
    process :class:`repro_torch.obs.Observability` fully enabled: a seeded
    ``ooc_gemm(tune="auto", devices=[gpu, phi])`` co-execution plus a tuned
    single-device GEMM, under canned profiles (simulation inputs, not
    measurements, so the plans and verdicts are deterministic), on the
    card (the host with ``--cpu``).  Emits:

      - a single Chrome trace (``--trace-out``) — tuner search, plan-cache
        lookups and the merge on pid 0, one executor lane-group per device;
      - the metrics + drift snapshot (``--json-out``);
      - a Markdown (default) or JSON report on stdout.

  * ``--input snapshot.json`` — render an existing snapshot (an
    ``obs.snapshot()`` document, e.g. a benchmark metrics sidecar) as the
    same report, without running anything.  ``--input`` may also name a
    *directory*: every ``*.metrics.json`` sidecar in it is merged into one
    report (counters and histograms add, gauges last-wins, drift records
    concatenate).

The demo also runs the attribution layer: the tuned plan's critical path,
bottleneck verdict and what-if sensitivity table, plus the hybrid run's
per-device imbalance attribution.  ``--check`` additionally asserts the
canned-profile verdicts are stable (the analyze smoke step): a phi-like
1-stream run must be transfer-bound, and the gpu 2-stream GEMM must keep
its exec stream >=80 % busy.

Example:
    python -m repro_torch.scripts.run_report --m 384 --trace-out t.json
    python -m repro_torch.scripts.run_report --cpu --check
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------
def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 2**63:
        return str(int(v))
    return f"{float(v):.6g}"


def render_markdown(snap: dict, trace_path: str = None) -> str:
    """Snapshot document -> Markdown report (metrics, drift, trace)."""
    lines = ["# OOC run report", ""]

    metrics = snap.get("metrics", [])
    lines += ["## Metrics", ""]
    if metrics:
        lines += ["| metric | type | labels | value |",
                  "|---|---|---|---|"]
        for fam in metrics:
            for s in fam.get("samples", ()):
                labels = " ".join(
                    f"{k}={v}" for k, v in sorted(s["labels"].items()))
                if fam.get("type") == "histogram":
                    value = (f"count={_fmt(s['count'])} "
                             f"sum={_fmt(s['sum'])}s")
                else:
                    value = _fmt(s["value"])
                lines.append(f"| `{fam['name']}` | {fam['type']} "
                             f"| {labels} | {value} |")
    else:
        lines.append("_no metrics recorded_")

    drift = snap.get("drift", {})
    rolling = drift.get("rolling", {})
    lines += ["", "## Drift (measured / predicted)", ""]
    if rolling:
        # last byte ratio per key comes from the raw records
        byte_ratio = {}
        for r in drift.get("records", ()):
            k = "|".join((r["kernel"], r["tier"], r["fingerprint"]))
            byte_ratio[k] = r.get("byte_ratio", 1.0)
        lines += ["| kernel\\|tier\\|fingerprint | n | first | last "
                  "| rolling mean | byte ratio |",
                  "|---|---|---|---|---|---|"]
        for key, row in sorted(rolling.items()):
            lines.append(
                f"| `{key}` | {row['n']} "
                f"| {row['first_time_ratio']:.3g} "
                f"| {row['last_time_ratio']:.3g} "
                f"| {row['mean_time_ratio']:.3g} "
                f"| {_fmt(byte_ratio.get(key, 1.0))} |")
        lines += ["",
                  "Byte ratios must be exactly 1 (executed transfers == "
                  "modeled transfers).  Time ratios are a *trend* signal: "
                  "a stable ratio means the calibrated profile still ranks "
                  "plans faithfully; a drifting one means recalibrate."]
    else:
        lines.append("_no drift records_")

    ana = snap.get("analysis")
    if ana:
        lines += ["", "## Attribution (tuned single-device plan)", "",
                  f"- verdict: **{ana['verdict']}** over a "
                  f"{ana['makespan_seconds']*1e3:.3g} ms predicted makespan",
                  "", "| critical-path class | seconds | share |",
                  "|---|---|---|"]
        for cls, secs in sorted(ana.get("class_seconds", {}).items(),
                                key=lambda kv: -kv[1]):
            share = ana.get("shares", {}).get(cls, 0.0)
            lines.append(f"| {cls} | {secs:.3e} | {share*100:.1f}% |")
        lines += ["", "| stream | ops | busy | utilization |",
                  "|---|---|---|---|"]
        for st in ana.get("streams", ()):
            lines.append(f"| {st['stream']} | {st['n_ops']} "
                         f"| {st['busy_seconds']:.3e}s "
                         f"| {st['utilization']*100:.1f}% |")
        gaps = ana.get("top_gaps", ())
        if gaps:
            lines += ["", "Top idle gaps (stream, seconds, blocked on):"]
            for g in gaps[:5]:
                lines.append(f"- s{g['stream']}: {g['seconds']:.3e}s before "
                             f"`{g['next_tag'] or 'drain'}` — {g['cause']}")

    rep = snap.get("whatif")
    if rep:
        base = rep["baseline"]
        lines += ["", "## What-if sensitivity", "",
                  f"Baseline: {base['nstreams']} stream(s), "
                  f"{base['nbuf']} buffer(s), "
                  f"{base['makespan']*1e3:.3g} ms.",
                  "", "| scenario | makespan | gain | speedup |",
                  "|---|---|---|---|"]
        for s in rep.get("scenarios", ()):
            if s["knob"] == "baseline":
                continue
            if not s.get("feasible", True):
                lines.append(f"| {s['name']} | _infeasible_ | — | — |")
                continue
            lines.append(f"| {s['name']} | {s['makespan']*1e3:.3g} ms "
                         f"| {s['gain_seconds']*1e3:+.3g} ms "
                         f"| {s['speedup']:.3f}x |")
        ranked = rep.get("ranked", ())
        if ranked:
            lines += ["", f"Best marginal resource: **{ranked[0]}**."]

    ha = snap.get("hybrid_analysis")
    if ha:
        lines += ["", "## Hybrid device attribution", "",
                  f"- critical device: **{ha['critical_device']}** "
                  f"({ha['makespan_seconds']*1e3:.3g} ms makespan)",
                  f"- imbalance (slowest-fastest)/slowest: "
                  f"{ha['imbalance']*100:.2f}%"]
        for name, d in sorted(ha.get("devices", {}).items()):
            utils = " ".join(
                f"s{st['stream']}={st['utilization']*100:.0f}%"
                for st in d.get("streams", ()))
            lines.append(f"- `{name}`: {d['verdict']}, "
                         f"{d['makespan_seconds']*1e3:.3g} ms, {utils}")

    trace = snap.get("trace")
    lines += ["", "## Trace", ""]
    if trace:
        lines.append(f"- control spans: {trace.get('control_spans', 0)}")
        for name, g in sorted(trace.get("groups", {}).items()):
            lines.append(f"- lane `{name}`: {g['spans']} spans, "
                         f"{g['span_seconds']*1e3:.2f} ms busy")
    else:
        lines.append("_no trace recorded_")
    if trace_path:
        lines.append(f"- written to `{trace_path}` "
                     f"(open at chrome://tracing or ui.perfetto.dev)")
    merged = snap.get("merged_from")
    if merged:
        lines += ["", "## Sources", ""]
        lines += [f"- `{p}`" for p in merged]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Demo run
# ---------------------------------------------------------------------------
def demo_run(m: int, seed: int, cache_path: str, torch_device=None):
    """The acceptance scenario, deterministic: one tuned single-device GEMM
    plus one hybrid co-executed GEMM under canned gpu/phi profiles, on
    ``torch_device`` (default CUDA)."""
    import numpy as np

    from repro_torch.core.oocgemm import ooc_gemm
    from repro_torch.hybrid import DeviceSpec
    from repro_torch.obs import get_observability
    from repro_torch.tune import (AutoTuner, PlanCache, gpu_profile,
                                  phi_profile)

    obs = get_observability()
    obs.reset()
    obs.enable(metrics=True, trace=True, trace_name="run-report")

    rng = np.random.default_rng(seed)
    M = N = K = m
    A = rng.standard_normal((M, K), dtype=np.float32)
    B = rng.standard_normal((K, N), dtype=np.float32)
    budget = (A.nbytes + B.nbytes + M * N * 4) // 3

    tuner = AutoTuner(profile=gpu_profile(), fingerprint="report",
                      cache=PlanCache(cache_path), max_steps=512,
                      torch_device=torch_device)
    out1 = ooc_gemm(A, B, budget_bytes=budget, tune="auto", tuner=tuner,
                    torch_device=torch_device)

    devices = [DeviceSpec("gpu0", gpu_profile(), budget),
               DeviceSpec("phi0", phi_profile(), budget)]
    out2 = ooc_gemm(A, B, budget_bytes=budget, tune="auto", devices=devices,
                    tolerance=0.1, torch_device=torch_device)

    ref = A @ B
    err = max(float(np.abs(out1.numpy() - ref).max()),
              float(np.abs(out2.numpy() - ref).max()))

    # attribution + what-if over the plan the tuner just chose (cache hit),
    # and per-device attribution of the hybrid split
    from repro_torch.hybrid.executor import analyze_hybrid
    from repro_torch.hybrid.plan import plan_hybrid_gemm
    from repro_torch.obs.analyze import analyze_plan
    from repro_torch.obs.whatif import whatif_plan

    plan = tuner.gemm_plan(M, N, K, budget)
    ana, res = analyze_plan(plan, gpu_profile())
    ana.verify_reconciliation(res)        # exact accounting, or blow up here
    obs.record_analysis(ana, kernel="gemm")
    rep = whatif_plan(plan, gpu_profile())
    obs.record_whatif(rep, kernel="gemm")
    hana = analyze_hybrid(plan_hybrid_gemm(M, N, K, devices,
                                           dtype="float32", tolerance=0.1))
    extras = {"analysis": ana.to_json(max_path=0), "whatif": rep.to_json(),
              "hybrid_analysis": hana.to_json()}
    return obs, err, extras


# ---------------------------------------------------------------------------
# Sidecar merging
# ---------------------------------------------------------------------------
def merge_snapshots(paths):
    """Merge several ``obs.snapshot()`` documents into one report document.

    Counters and histograms accumulate across files (histograms must agree
    on buckets), gauges keep the last file's value, drift records
    concatenate (rolling summaries recomputed over the combined history),
    trace groups merge by lane name.
    """
    merged = {"metrics": [], "drift": {"records": [], "rolling": {}},
              "merged_from": [str(p) for p in paths]}
    fams = {}                       # name -> family dict
    trace = None
    for path in paths:
        with open(path) as f:
            snap = json.load(f)
        for fam in snap.get("metrics", ()):
            cur = fams.get(fam["name"])
            if cur is None:
                fams[fam["name"]] = json.loads(json.dumps(fam))  # deep copy
                continue
            if cur.get("type") != fam.get("type"):
                raise SystemExit(
                    f"{path}: metric {fam['name']!r} is {fam.get('type')} "
                    f"here but {cur.get('type')} in an earlier sidecar")
            by_labels = {tuple(sorted(s["labels"].items())): s
                         for s in cur["samples"]}
            for s in fam.get("samples", ()):
                key = tuple(sorted(s["labels"].items()))
                have = by_labels.get(key)
                if have is None:
                    cur["samples"].append(json.loads(json.dumps(s)))
                    by_labels[key] = cur["samples"][-1]
                elif fam["type"] == "counter":
                    have["value"] += s["value"]
                elif fam["type"] == "histogram":
                    if cur.get("buckets") != fam.get("buckets"):
                        raise SystemExit(
                            f"{path}: histogram {fam['name']!r} bucket "
                            f"layout differs from an earlier sidecar")
                    have["counts"] = [a + b for a, b in
                                      zip(have["counts"], s["counts"])]
                    have["sum"] += s["sum"]
                    have["count"] += s["count"]
                else:                     # gauge (and anything point-in-time)
                    have["value"] = s["value"]
        merged["drift"]["records"].extend(
            snap.get("drift", {}).get("records", ()))
        tr = snap.get("trace")
        if tr:
            if trace is None:
                trace = {"control_spans": 0, "groups": {}}
            trace["control_spans"] += tr.get("control_spans", 0)
            for name, g in tr.get("groups", {}).items():
                have = trace["groups"].setdefault(
                    name, {"spans": 0, "span_seconds": 0.0})
                have["spans"] += g.get("spans", 0)
                have["span_seconds"] += g.get("span_seconds", 0.0)
    merged["metrics"] = [fams[n] for n in sorted(fams)]
    if trace is not None:
        merged["trace"] = trace
    by_key = {}
    for r in merged["drift"]["records"]:
        key = "|".join((r["kernel"], r["tier"], r["fingerprint"]))
        by_key.setdefault(key, []).append(r["time_ratio"])
    for key, ratios in sorted(by_key.items()):
        merged["drift"]["rolling"][key] = {
            "n": len(ratios),
            "mean_time_ratio": sum(ratios) / len(ratios),
            "last_time_ratio": ratios[-1],
            "first_time_ratio": ratios[0],
        }
    return merged


# ---------------------------------------------------------------------------
# Canned-verdict checks (the analyze smoke step)
# ---------------------------------------------------------------------------
def run_checks() -> int:
    """Assert the attribution verdicts on canned profiles are stable.

    1. A 1-stream, 1-buffer GEMM under the phi-like profile (shared
       transfer+compute engine) must come out **transfer-bound**.
    2. The gpu 2-stream fp64 GEMM at 4096^3 must keep its exec pool >=80 %
       busy — the overlap the canned profile was built to demonstrate.

    Both analyses must reconcile exactly against their simulations.
    """
    from repro_torch.core.partitioner import plan_gemm_partition
    from repro_torch.core.pipeline import compile_pipeline, gemm_pipeline_spec
    from repro_torch.obs.analyze import TraceAnalysis
    from repro_torch.tune import gpu_profile, phi_profile

    def compiled(M, bpe, budget, ns, nb):
        part = plan_gemm_partition(M, M, M, budget, bpe,
                                   nbuf=nb, nstreams=ns)
        spec = gemm_pipeline_spec(part, write_back=True, traversal="col",
                                  band=nb)
        return compile_pipeline(spec, nstreams=ns, nbuf=nb)

    failures = []

    m = 256
    sched = compiled(m, 4, (m * m * 4 * 3) // 2, ns=1, nb=1)
    ana, res = TraceAnalysis.analyze(sched, phi_profile().model_for(1))
    ana.verify_reconciliation(res)
    print(f"check phi/1-stream: {ana.digest()}")
    if ana.verdict != "transfer-bound":
        failures.append(f"phi 1-stream verdict {ana.verdict!r}, "
                        f"expected 'transfer-bound'")

    m = 4096
    sched = compiled(m, 8, (3 * m * m * 8) // 6, ns=2, nb=2)
    ana, res = TraceAnalysis.analyze(sched, gpu_profile().model_for(2))
    ana.verify_reconciliation(res)
    util = ana.pool_utilization("exec")
    print(f"check gpu/2-stream: exec utilization {util:.3f}; {ana.digest()}")
    if util < 0.8:
        failures.append(f"gpu 2-stream exec utilization {util:.3f} < 0.8")

    for f in failures:
        print(f"CHECK FAILED: {f}", file=sys.stderr)
    if not failures:
        print("analyze checks passed")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", default=None,
                    help="render an existing snapshot JSON (or a directory "
                         "of *.metrics.json sidecars, merged) instead of "
                         "running the demo")
    ap.add_argument("--check", action="store_true",
                    help="also assert the canned-profile attribution "
                         "verdicts are stable")
    ap.add_argument("--m", type=int, default=256,
                    help="demo GEMM order (M=N=K)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--format", choices=("markdown", "json"),
                    default="markdown", help="stdout report format")
    ap.add_argument("--trace-out", default=None,
                    help="write the demo's Chrome trace here")
    ap.add_argument("--json-out", default=None,
                    help="write the snapshot document here")
    ap.add_argument("--cpu", action="store_true",
                    help="run the demo on the host (the kernels' plain "
                         "versions) instead of the card")
    args = ap.parse_args(argv)

    trace_path = args.trace_out
    if args.input:
        if os.path.isdir(args.input):
            sidecars = sorted(
                os.path.join(args.input, n) for n in os.listdir(args.input)
                if n.endswith(".metrics.json"))
            if not sidecars:
                raise SystemExit(f"{args.input}: no *.metrics.json sidecars")
            snap = merge_snapshots(sidecars)
        else:
            with open(args.input) as f:
                snap = json.load(f)
            if "metrics" not in snap and "drift" not in snap:
                raise SystemExit(f"{args.input}: not a snapshot document "
                                 f"(no 'metrics'/'drift' keys)")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            obs, err, extras = demo_run(args.m, args.seed,
                                        os.path.join(tmp, "plans.json"),
                                        "cpu" if args.cpu else None)
        snap = obs.snapshot()
        snap["demo"] = {"m": args.m, "seed": args.seed, "max_abs_err": err}
        snap.update(extras)
        if trace_path:
            obs.tracer.write(trace_path)
        obs.reset()

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)

    if args.format == "json":
        json.dump(snap, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_markdown(snap, trace_path=trace_path))
    if args.check:
        return run_checks()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
