"""Quickstart: out-of-core GEMM through the card's memory tiers.

Port of ``examples/quickstart.py``: plan, schedule, validate, then
``ooc_gemm`` on the host-streaming and vmem backends, then the engine
model's estimate of the schedule.

    python -m repro_torch.examples.quickstart          # on the card
    python -m repro_torch.examples.quickstart --cpu    # plain versions
"""
import argparse

import numpy as np

from repro_torch.core import (build_gemm_schedule, gpu_like, ooc_gemm,
                              plan_gemm_partition, schedule_stats, simulate,
                              validate_schedule)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    M, N, K = 768, 640, 512
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    ref = 1.5 * A @ B + 0.5 * C
    budget = (A.nbytes + B.nbytes + C.nbytes) // 5   # force out-of-core

    # 1. plan: how does the hclMatrixPartitioner split this under the budget?
    part = plan_gemm_partition(M, N, K, budget, 4)
    print(f"partition: {part.h}x{part.w} blocks of {part.bm}x{part.bn} "
          f"(working set {part.working_set_bytes()/1e6:.2f} MB "
          f"<= budget {budget/1e6:.2f} MB)")

    # 2. schedule: the paper's Fig.2 event program, generated + validated
    sched = build_gemm_schedule(part, nstreams=2, nbuf=2)
    validate_schedule(sched)
    print(f"schedule: {schedule_stats(sched)}")

    # 3. execute on the host-streaming backend
    out = ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget, backend="host",
                   torch_device=torch_device)
    print(f"host backend max err: {np.abs(out.numpy() - ref).max():.2e}")

    # 4. execute through the vmem backend (one launch of the block GEMM)
    out_v = ooc_gemm(A, B, C, 1.5, 0.5, budget_bytes=budget, backend="vmem",
                     torch_device=torch_device)
    print(f"vmem backend max err: "
          f"{np.abs(out_v.cpu().numpy() - ref).max():.2e}")

    # 5. what would this schedule do on a GPU?  (the engine model's
    # estimate, not a measurement)
    hw = gpu_like()
    res = simulate(sched, hw)
    print(f"{hw.name} (model estimate): {res.effective_flops/1e9:.1f} "
          f"GFLOP/s effective, exec util {res.utilization('exec'):.2f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
