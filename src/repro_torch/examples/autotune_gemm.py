"""Autotune quickstart: calibrate -> search -> cache -> execute.

Port of ``examples/autotune_gemm.py``: the one-liner (``tune="auto"``,
which calibrates the device it runs on: the card, or the host with
``--cpu``), the plan cache paying off on the second call, and an explicit
AutoTuner on canned profiles reproducing the paper's C5 stream selection
(the K40c-like and Xeon-Phi-like profiles are simulation inputs, not
measurements of this machine).

    python -m repro_torch.examples.autotune_gemm          # on the card
    python -m repro_torch.examples.autotune_gemm --cpu    # plain versions
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core import ooc_gemm
from repro_torch.tune import AutoTuner, PlanCache, gpu_profile, phi_profile


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    M, N, K = 1024, 896, 512
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    ref = A @ B + C
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5    # force out-of-core

    with tempfile.TemporaryDirectory() as tmp:
        # 1. one-liner: calibrate this device (lazily, once per tuner),
        #    search, cache, execute.  An isolated cache keeps the demo
        #    hermetic.
        cache = PlanCache(os.path.join(tmp, "plans.json"))
        tuner = AutoTuner(cache=cache, torch_device=torch_device)
        t0 = time.perf_counter()
        out = ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget, tune="auto",
                       tuner=tuner, torch_device=torch_device)
        t1 = time.perf_counter()
        print(f"tune='auto': max err {np.abs(out.numpy() - ref).max():.2e} "
              f"({t1 - t0:.2f}s incl. calibration + search)")
        print(f"  calibrated: {tuner.profile.h2d_bw/1e9:.2f} GB/s H2D, "
              f"{tuner.profile.flops/1e9:.1f} GFLOP/s, "
              f"fingerprint {tuner.fingerprint}")

        # 2. second call: same shape + same hardware fingerprint = cache hit
        t0 = time.perf_counter()
        ooc_gemm(A, B, C, 1.0, 1.0, budget_bytes=budget, tune="auto",
                 tuner=tuner, torch_device=torch_device)
        t1 = time.perf_counter()
        assert tuner.last_from_cache and tuner.searches == 1
        print(f"second call: served from plan cache in {t1 - t0:.2f}s "
              f"({tuner.cache.hits} hit, {tuner.searches} search total)")

        # 3. what WOULD the tuner pick on the paper's hardware?  Canned
        #    profiles reproduce claim C5: 1 stream on Xeon Phi, 2 on a
        #    K40c-like GPU.
        shape = (8192, 8192, 8192)
        big_budget = 3 * 8192 * 8192 * 8 // 6
        for profile in (gpu_profile(), phi_profile()):
            sim_tuner = AutoTuner(profile=profile, cache=cache,
                                  fingerprint=f"demo-{profile.name}",
                                  nbuf_options=(1, 2), max_steps=128)
            plan = sim_tuner.gemm_plan(*shape, big_budget, dtype="float64")
            print(f"{profile.name}: picked nstreams={plan.nstreams} "
                  f"nbuf={plan.nbuf}, {plan.param('h')}x{plan.param('w')} "
                  f"blocks; {plan.baseline_makespan / plan.makespan:.2f}x "
                  f"vs default s2b2 (model estimate)")
    print("autotune quickstart OK")


if __name__ == "__main__":
    main()
