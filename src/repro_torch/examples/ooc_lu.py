"""OOC factorization quickstart: lookahead LU (and Cholesky) pipelines.

Port of ``examples/ooc_lu.py``: factors a host-resident matrix through ONE
compiled schedule that interleaves panel GETRF/TRSM ops with the streamed
GEMM trailing update — the paper's §VII future work.  Shows the
pivot-permutation contract, the simulated lookahead win over the
sequential per-panel loop on a K40c-like profile (a simulation input),
and the tuned plan.

    python -m repro_torch.examples.ooc_lu          # on the card
    python -m repro_torch.examples.ooc_lu --cpu    # plain versions
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import (compile_factor_pipeline, factor_pipeline_spec,
                              ooc_cholesky, ooc_lu, simulate)
from repro_torch.core.ooc_factor import panel_workspace_bytes
from repro_torch.tune import AutoTuner, PlanCache, gpu_profile


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    args = ap.parse_args()
    torch_device = "cpu" if args.cpu else None
    rng = np.random.default_rng(0)
    n = 512
    A = rng.standard_normal((n, n)).astype(np.float32)
    # on a card the budget also holds the panel ops' device workspace,
    # which the planner charges (nothing on the CPU: the reference's 4x)
    workspace = panel_workspace_bytes("lu", n, 128, 4,
                                      "cpu" if args.cpu else "cuda")
    budget = 4 * A.nbytes + workspace

    # 1. factor: LU, perm such that A[perm] = (tril(LU,-1) + I) @ triu(LU)
    LU, perm = ooc_lu(A, panel=128, budget_bytes=budget, lookahead=1,
                      validate=True, torch_device=torch_device)
    LU, perm = LU.numpy(), perm.numpy()
    L = np.tril(LU, -1) + np.eye(n, dtype=np.float32)
    U = np.triu(LU)
    err = np.abs(A[perm] - L @ U).max() / np.abs(A).max()
    print(f"ooc_lu: n={n}, panel=128, reconstruction err {err:.2e}, "
          f"{int((perm != np.arange(n)).sum())} rows pivoted")

    # ... and a solve through the factors (row-permute b, then L then U)
    b = rng.standard_normal(n).astype(np.float32)
    y = np.linalg.solve(L, b[perm])
    x = np.linalg.solve(U, y)
    print(f"solve via LU vs np.linalg.solve: "
          f"max err {np.abs(x - np.linalg.solve(A, b)).max():.2e}")

    # 2. Cholesky rides the same pipeline (POTRF/TRSM panels + SYRK
    #    trailing)
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    Lc = ooc_cholesky(S, panel=128, budget_bytes=budget,
                      torch_device=torch_device).numpy()
    print(f"ooc_cholesky: reconstruction err "
          f"{np.abs(Lc @ Lc.T - S).max() / np.abs(S).max():.2e}")

    # 3. why lookahead: simulate the same factorization on the paper's
    #    K40c-like profile, sequential vs lookahead event graphs (a model
    #    estimate, not a measurement)
    hw = gpu_profile().model_for(2)
    big = dict(n=8192, panel=512, bpe=8, budget=256 * 2**20)
    ms = {}
    for la in (0, 1):
        spec = factor_pipeline_spec(big["n"], big["panel"], big["budget"],
                                    big["bpe"], kind="cholesky",
                                    lookahead=la)
        ms[la] = simulate(compile_factor_pipeline(spec), hw).makespan
    print(f"simulated 8192^2 fp64 Cholesky on gpu-like: sequential "
          f"{ms[0]*1e3:.0f} ms, lookahead {ms[1]*1e3:.0f} ms "
          f"({ms[0]/ms[1]:.2f}x)")

    # 4. tune='auto': one cached search covers every shrinking trailing
    #    shape
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(os.path.join(tmp, "plans.json"))
        tuner = AutoTuner(profile=gpu_profile(), fingerprint="demo",
                          cache=cache, torch_device=torch_device)
        LU2, _ = ooc_lu(A, panel=128, budget_bytes=budget, tune="auto",
                        tuner=tuner, torch_device=torch_device)
        # the search ran at the budget less the panel ops' workspace,
        # and the plan is cached under that charged budget
        plan = tuner.factor_plan("lu", n, 128, budget - workspace)
        assert tuner.last_from_cache and tuner.searches == 1
        print(f"tuned: panel={plan.param('panel')} lookahead="
              f"{plan.param('lookahead')} s{plan.nstreams}b{plan.nbuf} "
              f"(1 search, then cache hits)")
    print("ooc factorization quickstart OK")


if __name__ == "__main__":
    main()
