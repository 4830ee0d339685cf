"""Concurrent execution quickstart: one OOC GEMM schedule, two modes.

Port of ``examples/concurrent_gemm.py``.  The schedule runs in the
issue-order mode (every op on one CUDA stream, in issue order: the
differential oracle) and in ``mode="concurrent"`` (each engine's ops on
its own CUDA stream, the schedule's event program realised as CUDA
events).  Three contracts:

  * results are **bitwise identical** and byte counters equal
    ``schedule_stats`` exactly in both modes;
  * the cached :class:`ExecutablePlan` makes repeat dispatch ~free;
  * the recorded spans show the engines' busy time against the run's
    makespan (on the card: CUDA-event spans of each op's device work).

The host issues every op from one thread in issue order, so
``last_completion_order`` is the issue order in both modes (the
reference's worker threads complete out of order; here the device
overlaps the engines' streams).

    python -m repro_torch.examples.concurrent_gemm          # on the card
    python -m repro_torch.examples.concurrent_gemm --cpu    # plain versions
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (ScheduleExecutor, build_gemm_schedule,
                              plan_cache_stats, plan_gemm_partition,
                              schedule_stats)
from repro_torch.core.api import hclCompileExecutable


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    M, N, K = 2048, 2048, 1024
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4   # genuinely out-of-core

    part = plan_gemm_partition(M, N, K, budget, 4, nbuf=2, nstreams=2)
    sched = build_gemm_schedule(part, nstreams=2, nbuf=2)
    stats = schedule_stats(sched)
    ctx = {"alpha": 1.0, "beta": 0.5}

    # 1. the ExecutablePlan: handlers, engine queues and dependency edges
    #    are pre-resolved once and cached on the schedule itself.
    t0 = time.perf_counter()
    plan = hclCompileExecutable(sched)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert hclCompileExecutable(sched) is plan       # cache hit
    t_warm = time.perf_counter() - t0
    print(f"1. plan: {plan.n_ops} ops on {len(plan.queues)} engines, "
          f"compile {t_cold*1e6:.0f}us -> cached {t_warm*1e6:.1f}us "
          f"(stats: {plan_cache_stats()})")

    # 2. issue order vs concurrent: bitwise outputs, exact byte counters.
    outs = {}
    for mode in ("issue_order", "concurrent"):
        ex = ScheduleExecutor(mode=mode, record_spans=True,
                              torch_device=torch_device)
        out = {"C": torch.from_numpy(C.copy())}
        ex.run(sched, {"A": A, "B": B}, out, ctx)
        assert ex.last_h2d_bytes == stats["h2d_bytes"]
        assert ex.last_d2h_bytes == stats["d2h_bytes"]
        busy = sum(t1 - t0 for _, _, t0, t1 in ex.last_spans)
        span = (max(t1 for *_, t1 in ex.last_spans)
                - min(t0 for _, _, t0, _ in ex.last_spans))
        outs[mode] = out["C"]
        print(f"2. {mode:<12} {ex.last_wall_seconds*1e3:6.0f}ms  engine "
              f"busy/makespan = {busy/span:.2f}x")
    assert torch.equal(outs["issue_order"], outs["concurrent"])
    print("   bitwise identical: True")
    err = np.abs(outs["concurrent"].numpy() - (A @ B + 0.5 * C)).max()
    print(f"3. max err vs numpy: {err:.2e}")
    print("concurrent_gemm OK")


if __name__ == "__main__":
    main()
