"""Resilience quickstart: the four fault classes, each recovered exactly.

Port of ``examples/faulty_gemm.py``: a seeded FaultPlan injects transfer
errors, compute corruption, OOM and device loss into one OOC GEMM, and
every recovery path — retry, block replay, degrade ladder, hybrid
rebalance — returns a result **bitwise identical** to the fault-free run.
The float64 operands are computed in float32, as the reference computes
them with JAX's 64-bit mode off.

    python -m repro_torch.examples.faulty_gemm          # on the card
    python -m repro_torch.examples.faulty_gemm --cpu    # plain versions
"""
import argparse

import numpy as np
import torch

from repro_torch.core import ooc_gemm
from repro_torch.core.api import hclFaultPolicy
from repro_torch.fault import FaultPlan, FaultSpec
from repro_torch.hybrid import DeviceSpec, plan_hybrid_gemm, run_hybrid_gemm
from repro_torch.tune import gpu_profile, phi_profile


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    M, N, K = 512, 256, 128
    A = rng.standard_normal((M, K))
    B = rng.standard_normal((K, N))
    C = rng.standard_normal((M, N))
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5   # genuinely out-of-core

    clean = ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=budget, backend="host",
                     torch_device=dev)
    policy = hclFaultPolicy(backoff_base=1e-4)       # fast demo backoff

    # 1. random seeded faults: transfer retries + compute replays.  The
    #    same (seed, rate) always injects the same (op, class) set — a
    #    failure here would be exactly reproducible.
    def run(faults):
        return ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=budget,
                        backend="host", faults=faults, fault_policy=policy,
                        torch_device=dev)

    cap = {}

    def seeded(sched):
        cap["inj"] = FaultPlan.random(7, sched, rate=0.25).injector()
        return cap["inj"]

    out = run(seeded)
    inj = cap["inj"]
    print(f"1. random faults: injected {len(inj.injected)} "
          f"({sorted(set(c for _, c in inj.injected))}), "
          f"bitwise identical: {torch.equal(out, clean)}")

    # 2. a pinned retry storm: op 0 (an H2D) fails twice, the third attempt
    #    succeeds; nominal byte counters are untouched by the failed tries.
    out = run(FaultPlan(specs=(FaultSpec(op=0, cls="h2d_error", times=2),)))
    print(f"2. retry storm:  bitwise identical: {torch.equal(out, clean)}")

    # 3. OOM: the planner's degrade ladder (halve nbuf -> halve budget)
    #    replans and re-runs fault-free.  Because the partitioner never
    #    splits K, the degraded plan is still bitwise.
    pol = hclFaultPolicy(backoff_base=1e-4)

    def oom_everywhere(sched):
        return FaultPlan(specs=(FaultSpec(op=0, cls="oom", times=99),)
                         ).injector()

    out = ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=budget, backend="host",
                   faults=oom_everywhere, fault_policy=pol, torch_device=dev)
    print(f"3. oom ladder:   degraded via {[d.action for d in pol.degrades]}"
          f", bitwise identical: {torch.equal(out, clean)}")

    # 4. device loss mid-hybrid: gpu0 dies on its first op; its C band is
    #    replanned across the survivors and recomputed from pristine inputs.
    devices = [DeviceSpec("gpu0", gpu_profile(), budget),
               DeviceSpec("phi0", phi_profile(), budget)]
    hplan = plan_hybrid_gemm(M, N, K, devices, nbuf_options=(1, 2),
                             max_steps=256)
    ref_h, _ = run_hybrid_gemm(A, B, C, 1.0, 0.5, hplan, torch_device=dev)
    lost_plan = FaultPlan(specs=(FaultSpec(op=0, cls="device_lost"),))
    out, groups = run_hybrid_gemm(A, B, C, 1.0, 0.5, hplan,
                                  fault_plans={"gpu0": lost_plan},
                                  fault_policy=hclFaultPolicy(),
                                  torch_device=dev)
    print(f"4. device lost:  bands {[g for g, _ in groups]}, "
          f"bitwise identical: {torch.equal(out, ref_h)}")
    print("faulty gemm quickstart OK")


if __name__ == "__main__":
    main()
