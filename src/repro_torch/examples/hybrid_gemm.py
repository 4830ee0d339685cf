"""Hybrid quickstart: one GEMM co-scheduled across a GPU+Phi profile pair.

Port of ``examples/hybrid_gemm.py``.  The balance -> plan -> co-execute ->
merge pipeline in ~40 lines: split C's rows so the paper's two canned
device profiles predict equal finish times, tune each band, run both
schedules concurrently, and compare against the best single device.  Both
members run on one torch device (the card, or the CPU with ``--cpu``),
each on an executor and streams of its own: a member is a profile and a
budget, as in the reference.

    python -m repro_torch.examples.hybrid_gemm          # on the card
    python -m repro_torch.examples.hybrid_gemm --cpu    # plain versions
"""
import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import ooc_gemm
from repro_torch.hybrid import DeviceSpec, plan_hybrid_gemm, simulate_hybrid
from repro_torch.tune import gpu_profile, phi_profile
from repro_torch.tune.search import search_gemm


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    ap.add_argument("--trace", default=os.path.join(tempfile.gettempdir(),
                                                    "hybrid_trace.json"),
                    help="where to write the predicted Chrome trace")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    M, N, K = 1536, 1024, 512
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    ref = A @ B + C
    budget = (M * K + K * N + M * N) * 4 // 4     # per-device tier budget

    # 1. the device set: the paper's testbed pair, as canned profiles
    devices = [DeviceSpec("gpu0", gpu_profile(), budget),
               DeviceSpec("phi0", phi_profile(), budget)]

    # 2. balance + tune: shares sized so predicted finish times equalize,
    #    each band planned by tune.search under its own profile
    hplan = plan_hybrid_gemm(M, N, K, devices, nbuf_options=(1, 2),
                             max_steps=256)
    for dp in hplan.device_plans:
        print(f"{dp.device.name}: rows [{dp.start}, {dp.start + dp.length}) "
              f"s{dp.plan.nstreams}b{dp.plan.nbuf} "
              f"-> predicted {dp.plan.makespan * 1e3:.2f} ms")
    print(f"balanced in {hplan.balance.iterations} iters, "
          f"finish-time spread {hplan.balance.spread:.3f} "
          f"(tolerance {hplan.tolerance})")

    # 3. predicted payoff vs. the best single device (engine model)
    sim = simulate_hybrid(hplan)
    best_single = min(
        search_gemm(M, N, K, d.budget_bytes, d.profile, fingerprint="demo",
                    nbuf_options=(1, 2), max_steps=256).makespan
        for d in devices)
    print(f"hybrid {sim.makespan * 1e3:.2f} ms vs best single "
          f"{best_single * 1e3:.2f} ms -> {best_single / sim.makespan:.2f}x "
          f"(model estimate)")

    # 4. co-execute for real: one entry-point call, exact result
    out = ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget, devices=devices,
                   torch_device=torch_device)
    print(f"max err vs oracle: {np.abs(out.numpy() - ref).max():.2e}")

    # 5. one Chrome-trace lane-group per device (pid = device index)
    with open(args.trace, "w") as f:
        json.dump(sim.to_chrome_trace(), f)
    print(f"wrote {args.trace} — load at chrome://tracing or "
          f"ui.perfetto.dev")
    print("hybrid quickstart OK")


if __name__ == "__main__":
    main()
