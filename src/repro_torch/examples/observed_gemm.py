"""Observability quickstart: one switch, three outputs, and the attribution.

Port of ``examples/observed_gemm.py``.  Runs the acceptance scenario — a
tuned single-device GEMM plus a hybrid co-execution across the canned
gpu+phi profiles — with the process :class:`repro_torch.obs.Observability`
enabled, then shows the three pillars:

  1. **Metrics** — exact byte/flop/op accounting in Prometheus text
     (``repro_executor_h2d_bytes`` equals the schedule's modeled total, to
     the byte).
  2. **Trace** — one Chrome-trace timeline: tuner search and plan-cache
     lookups on the control lane, one executor lane-group per device, the
     merge span closing the run.  Open it at chrome://tracing or
     https://ui.perfetto.dev.
  3. **Drift** — predicted-vs-measured per (kernel, tier, fingerprint):
     byte ratios must be exactly 1.0; time ratios are the
     calibration-staleness trend signal.
  4. **Attribution** — the tuned plan's exact critical path, bottleneck
     verdict and what-if sensitivity: which resource buys the next
     makespan reduction, and why the tuner chose what it chose.

The canned profiles are simulation inputs (the paper's K40c-like and Xeon
Phi-like devices), not measurements of this machine, so the plans and the
attribution do not depend on where the GEMMs run.

    python -m repro_torch.examples.observed_gemm          # on the card
    python -m repro_torch.examples.observed_gemm --cpu    # plain versions
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import ooc_gemm
from repro_torch.core.api import hclObservability
from repro_torch.hybrid import DeviceSpec
from repro_torch.obs.analyze import analyze_plan
from repro_torch.obs.whatif import whatif_plan
from repro_torch.tune import AutoTuner, PlanCache, gpu_profile, phi_profile


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None

    # one switch: metrics + trace + drift all report into this singleton
    obs = hclObservability(enable=True, trace=True,
                           trace_name="observed-gemm")
    rng = np.random.default_rng(0)
    M = N = K = 512
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + M * N * 4) // 3   # force out-of-core

    with tempfile.TemporaryDirectory() as tmp:
        # tuned single-device run (canned profile: no calibration)
        cache = PlanCache(os.path.join(tmp, "plans.json"))
        tuner = AutoTuner(profile=gpu_profile(), fingerprint="demo",
                          cache=cache, max_steps=512,
                          torch_device=torch_device)
        out = ooc_gemm(A, B, budget_bytes=budget, tune="auto", tuner=tuner,
                       torch_device=torch_device)

        # hybrid co-execution: same kernel, two members, one timeline
        devices = [DeviceSpec("gpu0", gpu_profile(), budget),
                   DeviceSpec("phi0", phi_profile(), budget)]
        out2 = ooc_gemm(A, B, budget_bytes=budget, tune="auto",
                        devices=devices, tolerance=0.1,
                        torch_device=torch_device)

        ref = A @ B
        print(f"max err: single {np.abs(out.numpy() - ref).max():.2e}, "
              f"hybrid {np.abs(out2.numpy() - ref).max():.2e}\n")

        # 1. metrics: the exact accounting behind the run
        print("--- metrics (Prometheus exposition, excerpt) ---")
        for line in obs.metrics.to_prometheus_text().splitlines():
            if line.startswith(("repro_executor_h2d_bytes",
                                "repro_executor_runs_total",
                                "repro_tune_searches_total",
                                "repro_plancache_")):
                print(line)

        # 2. one coherent Chrome trace: control lane + per-device lanes
        trace_path = os.path.join(tmp, "observed_gemm_trace.json")
        obs.tracer.write(trace_path)
        summ = obs.tracer.summary()
        print(f"\n--- trace ({os.path.getsize(trace_path)} B written) ---")
        print(f"control spans: {summ['control_spans']}")
        for name, g in sorted(summ["groups"].items()):
            print(f"lane {name!r}: {g['spans']} spans, "
                  f"{g['span_seconds']*1e3:.2f} ms busy")

        # 3. drift: every tuned run recorded its prediction beside the
        #    measurement
        print("\n--- drift (measured / predicted) ---")
        for key, row in sorted(obs.drift.snapshot()["rolling"].items()):
            print(f"{key}: n={row['n']} "
                  f"time_ratio={row['last_time_ratio']:.3g}")
        for rec in obs.drift.records():
            assert rec.byte_ratio == 1.0, "executed bytes must match the model"
        print("byte ratios: all exactly 1.0 (executed == modeled transfers)")

        # 4. attribution: replay the tuned plan's schedule, walk its exact
        #    critical path, and ask what the next resource increment buys
        plan = tuner.gemm_plan(M, N, K, budget)          # cache hit
    ana, res = analyze_plan(plan, gpu_profile())
    ana.verify_reconciliation(res)                    # exact, or raises
    print("\n--- attribution ---")
    print(ana.digest())
    for g in ana.top_gaps(3):
        print(f"  idle s{g.stream} {g.duration*1e6:.1f}us before "
              f"{g.next_tag or 'drain'}: {g.cause}")
    rep = whatif_plan(plan, gpu_profile())
    for sc in rep.ranked():
        print(f"  what-if {sc.name}: {sc.gain_seconds*1e3:+.3f} ms "
              f"({sc.speedup:.3f}x)")
    obs.reset()
    obs.disable()
    print("observed gemm OK")


if __name__ == "__main__":
    main()
