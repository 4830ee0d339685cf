"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and the
repository's ``src/`` beside this file; it builds every kernel of
``src/repro_torch/csrc`` itself.  Without a card it exits non-zero before
printing any result.  Phases (each raises on failure; none is skipped):

  1. environment: card name and power limit, versions, kernel build;
  2. every kernel against its plain PyTorch version at the reference test
     shapes (f32/bf16/f16, ragged edges), ``block=`` variants and
     sub-blocks bit for bit;
  3. the main path, MMOOC: ``ooc_gemm`` host backend at
     M = N = K = 24576 f32 under a 2 GiB device budget (3.4x out of core),
     in both executor modes, checked bit for bit across modes and against
     the in-core path, against float64 on sampled rows, byte counters
     against ``schedule_stats``, launch counts and peak device memory;
  4. the vmem backend at the same size and ``ooc_syrk`` host at
     n = 16384, K = 8192 under 1 GiB;
  5. kernel timing at the main path's block shape beside its bound, the
     plain version and one library call.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

SEED = 0
U32 = 2.0 ** -24          # float32 unit roundoff
# NVIDIA H100 SXM5 data sheet, dense, at the full power limit: float32
# FLOP/s on the CUDA cores and HBM3 bytes/s.  torch names the card
# "NVIDIA H100 80GB HBM3"; any other card raises.
H100_SXM = ("H100 80GB HBM3", 67e12, 3.35e12)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def datasheet(name: str):
    key, peak_flops, peak_bw = H100_SXM
    if key not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}")
    return peak_flops, peak_bw


def rand(shape, gen, dtype=torch.float32, device="cuda"):
    return torch.randn(shape, generator=gen, device="cuda").to(
        dtype=dtype, device=device)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sum_tol(A, B, C, alpha, beta):
    """Per-element rounding budget of one float32 sum over K terms:
    sqrt(K) * u * sum_k |alpha a_ik b_kj| (+ |beta c_ij|), the probabilistic
    bound for recursive summation of random-sign terms (Higham, Accuracy
    and Stability of Numerical Algorithms, 2nd ed., section 4.2)."""
    K = A.shape[1]
    mag = abs(alpha) * (A.abs().double() @ B.abs().double()) \
        + abs(beta) * C.abs().double()
    return math.sqrt(K) * U32 * mag


def phase_env():
    line = card_line()
    say("env", f"card: {line}")
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}, "
               f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    log = _build.build("block_matmul")
    say("env", f"block_matmul: {log['path']} built in "
               f"{log['seconds']:.2f} s"
               + (" (already built)" if log["cached"] else ""))
    for ln in log["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln:
            say("env", f"  ptxas {ln.strip()}")
    return line


def phase_kernels(gen):
    from repro_torch.kernels.block_matmul import block_matmul, \
        block_matmul_plain

    tols = {torch.float32: 2e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
    shapes = [(128, 128, 128), (256, 384, 512), (300, 200, 150),
              (512, 128, 257), (64, 64, 64), (1000, 999, 1001)]
    blocks = [(512, 512, 512), (64, 64, 64)]
    for dt, tol in tols.items():
        for M, N, K in shapes:
            A, B, C = (rand(s, gen, dt) for s in ((M, K), (K, N), (M, N)))
            outs = [block_matmul(A, B, C, alpha=1.25, beta=0.5, block=blk)
                    for blk in blocks]
            ref = block_matmul_plain(A, B, C, alpha=1.25, beta=0.5)
            torch.cuda.synchronize()
            err = (outs[0].float() - ref.float()).abs()
            bound = tol + tol * ref.float().abs()
            require(bool((err <= bound).all()),
                    f"block_matmul {dt} {(M, N, K)}: max err "
                    f"{err.max().item()} beyond rtol=atol={tol}")
            require(all(torch.equal(outs[0], o) for o in outs[1:]),
                    f"block_matmul {dt} {(M, N, K)}: block= variants "
                    f"differ")
            r0, r1, c0, c1 = M // 3, M - 5, N // 4, N - 3
            sub = block_matmul(A[r0:r1], B[:, c0:c1], C[r0:r1, c0:c1],
                               alpha=1.25, beta=0.5)
            require(torch.equal(sub, outs[0][r0:r1, c0:c1]),
                    f"block_matmul {dt} {(M, N, K)}: sub-block differs "
                    f"from the slice of the full product")
            say("kernel", f"block_matmul {str(dt)[6:]:8s} {M}x{N}x{K}: "
                          f"max err {err.max().item():.3g} "
                          f"(rtol=atol={tol}); {len(blocks)} block= "
                          f"variants and a sub-block bitwise equal")


def dgemm_ops(sched) -> int:
    from repro_torch.core import BlockRef, OpKind

    return sum(1 for op in sched.ops if op.kind == OpKind.COMPUTE
               and isinstance(op.payload, BlockRef)
               and op.payload.kernel == "dgemm")


def phase_main(gen, report):
    from repro_torch.core import (HostOocRuntime, OpKind, ScheduleExecutor,
                                  build_gemm_schedule, ooc_gemm,
                                  plan_gemm_partition, schedule_stats)
    from repro_torch.kernels.block_matmul import block_matmul

    M = N = K = 24576
    budget = 2 * 2**30
    alpha, beta = 1.5, 0.5
    t0 = time.perf_counter()
    A, B, C = (rand(s, gen, device="cpu") for s in ((M, K), (K, N), (M, N)))
    say("main", f"host operands {M}x{K}, {K}x{N}, {M}x{N} f32 made on the "
                f"card from seed {SEED} in {time.perf_counter() - t0:.1f} s; "
                f"{3 * M * K * 4 / budget:.2f}x the {budget / 2**30:.0f} GiB "
                f"budget")
    part = plan_gemm_partition(M, N, K, budget, 4)
    sched = build_gemm_schedule(part, nstreams=2, nbuf=2)
    stats = schedule_stats(sched)
    n_dgemm = dgemm_ops(sched)
    ws = part.working_set_bytes(nbuf=2, nstreams=2)
    slack = 64 * 2**20
    say("main", f"partition {part.h}x{part.w} of {part.bm}x{part.bn} blocks; "
                f"schedule_stats {json.dumps(stats)}; {n_dgemm} dgemm ops; "
                f"working set (nbuf=2) {ws} B")

    outs = {}
    for mode in ("issue_order", "concurrent"):
        ex = ScheduleExecutor(mode=mode)
        rt = HostOocRuntime(executor=ex)
        for rep in ("cold", "warm"):
            ex.record_spans = rep == "warm"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            block_matmul.launches = 0
            out = ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget,
                           backend="host", nstreams=2, nbuf=2, runtime=rt)
            launches = block_matmul.launches
            peak = torch.cuda.max_memory_allocated() - base
            require(launches == n_dgemm,
                    f"{mode}: {launches} kernel launches, expected "
                    f"{n_dgemm} (one per dgemm op)")
            require(ex.last_h2d_bytes == stats["h2d_bytes"]
                    and ex.last_d2h_bytes == stats["d2h_bytes"],
                    f"{mode}: moved {ex.last_h2d_bytes}/{ex.last_d2h_bytes} "
                    f"B, schedule_stats says {stats['h2d_bytes']}/"
                    f"{stats['d2h_bytes']}")
            require(peak <= ws + slack,
                    f"{mode}: peak device memory {peak} B above the working "
                    f"set {ws} B + {slack} B slack")
            wall = ex.last_wall_seconds
            row = {"mode": mode, "run": rep, "wall_s": wall,
                   "tflops": stats["flops"] / wall / 1e12,
                   "launches": launches, "peak_bytes": peak,
                   "h2d_bytes": ex.last_h2d_bytes,
                   "d2h_bytes": ex.last_d2h_bytes}
            if ex.last_spans:
                busy = {}
                for op, span in zip(sched.ops, ex.last_spans):
                    busy[op.kind] = busy.get(op.kind, 0.0) \
                        + span[3] - span[2]
                row["h2d_gbps"] = stats["h2d_bytes"] / busy[OpKind.H2D] / 1e9
                row["d2h_gbps"] = stats["d2h_bytes"] / busy[OpKind.D2H] / 1e9
                row["device_busy_s"] = {k.name: v for k, v in busy.items()}
                covered, reach = 0.0, 0.0   # union of the op spans
                for _, _, t0, t1 in sorted(ex.last_spans,
                                           key=lambda s: s[2]):
                    covered += max(0.0, t1 - max(t0, reach))
                    reach = max(reach, t1)
                row["device_idle_share"] = 1.0 - covered / wall
            report["main_path"].append(row)
            say("main", f"{mode:11s} {rep}: {wall:.3f} s wall, "
                        f"{row['tflops']:.2f} TFLOP/s effective, "
                        f"{launches} launches, bytes = schedule_stats, "
                        f"peak {peak / 2**30:.3f} GiB <= working set "
                        f"{ws / 2**30:.3f} GiB + 64 MiB slack (allocator "
                        f"rounding)"
                        + (f", H2D {row['h2d_gbps']:.1f} GB/s, D2H "
                           f"{row['d2h_gbps']:.1f} GB/s over device copy "
                           f"time, device idle "
                           f"{100 * row['device_idle_share']:.1f} % of the "
                           f"wall" if "h2d_gbps" in row else ""))
            if rep == "cold":
                outs[mode] = out
                report["launches"]["host"] = launches
            del out
    require(torch.equal(outs["issue_order"], outs["concurrent"]),
            "issue_order and concurrent results differ")
    say("main", "issue_order == concurrent, bitwise")
    host_out = outs.pop("issue_order")
    outs.clear()

    block_matmul.launches = 0
    incore = ooc_gemm(A, B, C, alpha, beta, budget_bytes=1 << 40,
                      backend="host")
    report["launches"]["in_core"] = block_matmul.launches
    require(block_matmul.launches == 1, "in-core path is not one launch")
    require(torch.equal(incore, host_out),
            "out-of-core result differs from the in-core launch")
    del incore
    say("main", "out-of-core == in-core (one launch on the whole problem), "
                "bitwise")

    rows = torch.randperm(M, generator=torch.Generator().manual_seed(SEED))[
        :256].sort().values
    Ar = A[rows].cuda()
    Bd = B.cuda()
    Cr = C[rows].cuda()
    exact = alpha * (Ar.double() @ Bd.double()) + beta * Cr.double()
    tol = sum_tol(Ar, Bd, Cr, alpha, beta)
    err = (host_out[rows].cuda().double() - exact).abs()
    require(bool((err <= tol).all()),
            f"sampled rows: max err {err.max().item()} beyond the float32 "
            f"summation bound (max {tol.max().item()})")
    say("main", f"256 sampled rows vs float64: max abs err "
                f"{err.max().item():.4g}, max err/bound "
                f"{(err / tol).max().item():.3g}, "
                f"all within sqrt(K)*u*sum|terms| (max "
                f"{tol.max().item():.3g}): a sequential f32 sum over "
                f"K = {K}")
    del Ar, Bd, Cr, exact, tol, err
    return A, B, C, host_out, (alpha, beta, budget)


def phase_vmem_syrk(gen, report, A, B, C, host_out, params):
    from repro_torch.core import ooc_gemm, ooc_syrk, build_syrk_schedule, \
        plan_gemm_partition, HostOocRuntime, ScheduleExecutor
    from repro_torch.kernels.block_matmul import block_matmul

    alpha, beta, budget = params
    Ad, Bd, Cd = A.cuda(), B.cuda(), C.cuda()
    block_matmul.launches = 0
    vout = ooc_gemm(Ad, Bd, Cd, alpha, beta, budget_bytes=budget,
                    backend="vmem")
    report["launches"]["vmem"] = block_matmul.launches
    require(block_matmul.launches == 1, "vmem backend is not one launch")
    del Ad, Bd, Cd
    require(torch.equal(vout.cpu(), host_out),
            "vmem result differs from the host path")
    del vout
    say("vmem", "backend='vmem' on device-resident operands == host path, "
                "bitwise (1 launch)")

    n, K = 16384, 8192
    sbudget = 2**30
    P = rand((n, K), gen, device="cpu")
    Cs = rand((n, n), gen, device="cpu")
    part = plan_gemm_partition(n, n, K, sbudget, 4)
    sched = build_syrk_schedule(part, nstreams=2, nbuf=2)
    ex = ScheduleExecutor()
    block_matmul.launches = 0
    out = ooc_syrk(P, Cs, -1.0, 0.5, budget_bytes=sbudget, backend="host",
                   runtime=HostOocRuntime(executor=ex))
    report["launches"]["syrk_host"] = block_matmul.launches
    require(block_matmul.launches == dgemm_ops(sched),
            f"syrk: {block_matmul.launches} launches, expected "
            f"{dgemm_ops(sched)}")
    Pd = P.cuda()
    incore = block_matmul(Pd, Pd.T.contiguous(), Cs.cuda(), alpha=-1.0,
                          beta=0.5)
    require(torch.equal(out, incore.cpu()),
            "ooc_syrk differs from the kernel's in-core P @ P^T")
    say("syrk", f"ooc_syrk host n={n} K={K} under 1 GiB: partition "
                f"{part.h}x{part.w}, {report['launches']['syrk_host']} "
                f"launches, {ex.last_wall_seconds:.3f} s wall, == in-core "
                f"P @ P^T bitwise")


def phase_timing(gen, report, card):
    from repro_torch.kernels.block_matmul import block_matmul, \
        block_matmul_plain

    M = N = 6144
    K = 24576
    alpha, beta = 1.5, 0.5
    A, B, C = (rand(s, gen) for s in ((M, K), (K, N), (M, N)))
    out = torch.empty_like(C)
    launches = block_matmul.launches
    ms = time_ms(lambda: block_matmul(A, B, C, alpha=alpha, beta=beta,
                                      out=out))
    block_matmul.launches = launches   # timing launches are not the path's
    plain_ms = time_ms(lambda: block_matmul_plain(A, B, C, alpha=alpha,
                                                  beta=beta))
    library_ms = time_ms(lambda: torch.addmm(C, A, B, beta=beta,
                                             alpha=alpha))
    ref = block_matmul_plain(A, B, C, alpha=alpha, beta=beta)
    err = (out - ref).abs()
    tol = 2 * sum_tol(A, B, C, alpha, beta)
    require(bool((err.double() <= tol).all()),
            f"timing shape: kernel vs plain max err {err.max().item()}")
    flops = 2 * M * N * K + 3 * M * N
    nbytes = (M * K + K * N + 2 * M * N) * 4
    peak_flops, peak_bw = datasheet(torch.cuda.get_device_name(0))
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / peak_bw * 1e3
    entry = {
        "name": "block_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul.py:36",
        "launches": sum(report["launches"][k]
                        for k in ("host", "in_core", "vmem")),
        "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    say("timing", f"block_matmul {M}x{N}x{K} f32: {ms:.3f} ms/launch "
                  f"({flops / ms / 1e9:.2f} TFLOP/s), bound {entry['bound_ms']:.3f}"
                  f" ms ({entry['bound_by']}: {peak_flops / 1e12:.0f} TFLOP/s "
                  f"f32 non-tensor, data sheet), plain {plain_ms:.3f} ms, "
                  f"torch.addmm {library_ms:.3f} ms; kernel vs plain max "
                  f"err {entry['max_abs_err']:.3g} (bound 2*sqrt(K)*u*"
                  f"sum|terms|); card {card}")
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_env()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_kernels(gen)
    report = {"main_path": [], "launches": {}}
    A, B, C, host_out, params = phase_main(gen, report)
    phase_vmem_syrk(gen, report, A, B, C, host_out, params)
    del A, B, C, host_out
    entry = phase_timing(gen, report, card)
    say("done", f"launches by path {json.dumps(report['launches'])}; "
                f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"main_path": report["main_path"], "card": card}))
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
