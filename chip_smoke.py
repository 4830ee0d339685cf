"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and the
repository's ``src/`` beside this file; it builds every kernel of
``src/repro_torch/csrc`` itself.  Without a card it exits non-zero before
printing any result.  Phases (each raises on failure; none is skipped):

  1. environment: card name and power limit, versions, kernel builds
     (one ``nvcc`` per source, all started together);
  2. every kernel against its plain PyTorch version at the reference test
     shapes: the block GEMM (f32/bf16/f16, ragged edges, ``block=``
     variants and sub-blocks bit for bit), the flash-decoding pair
     (f32/bf16/f16 KV, q in f32 and in the KV dtype, ragged lengths, a
     fully masked split, a row of length 0, two runs bit for bit) and the
     direct GEMM, kernel 3 (``direct_vmem_ooc_gemm``: f32/bf16/f16,
     ``block=`` variants and two launches bit for bit, C unchanged, and
     bit for bit equal to kernel 1; ``[direct]`` lines);
  3. the first path, MMOOC: ``ooc_gemm`` host backend at
     M = N = K = 24576 f32 under a 2 GiB device budget (3.4x out of core),
     in both executor modes, checked bit for bit across modes and against
     the in-core path, against float64 on sampled rows, byte counters
     against ``schedule_stats``, launch counts and peak device memory;
  4. the vmem backend at the same size and ``ooc_syrk`` host at
     n = 16384, K = 8192 under 1 GiB;
  5. the third path, the paper's direct baselines and claim C1
     (``[c1]`` lines), on phase 3's operands: ``direct_host_ooc_gemm``
     checked (launches, bytes, bit for bit equal to phase 3's result),
     then ``ooc_gemm`` (API), ``HostOocRuntime.gemm`` on a prebuilt
     schedule (floor) and ``direct_host_ooc_gemm`` (direct), warm and
     interleaved, plus the API in ``concurrent`` mode, at 24576^3 under
     2 GiB and at the reference's largest size, 1536x1024x512 under a
     fifth of the operands; then the vmem tier, ``ooc_gemm(backend=
     "vmem")`` against ``direct_vmem_ooc_gemm`` on 8192^3 f32 operands on
     the card;
  6. the second path, decode attention: ``ooc_attention`` at llama3.2-3b's
     attention widths (H = 24, Hkv = 8, d = 128) over a long_500k cache
     (S = 524288, bf16, 2 GiB) under a 512 MiB budget, in both executor
     modes, cold and warm: bit for bit across modes, against float64 on the
     card and the kernel on the whole cache, byte counters, launches, peak
     device memory, and the warm runs' transfer and idle times; then f32 KV
     at S = 131072 under 256 MiB with the same checks;
  7. the 16-bit path, MMOOC in bf16 (``[bf16]`` lines): ``ooc_gemm`` host
     backend at 24576^3 bf16 under 1 GiB (the f32 cell's 4x4 plan at half
     the bytes, so kernel 1 on the tensor cores leaves the transfers as the
     bound), in both executor modes: launches, bytes against
     ``schedule_stats``, peak device memory, the modes and one in-core
     launch bit for bit, and a float32 ``torch.addmm`` on the card as the
     oracle;
  8. kernel timing at each path's shapes beside its bound, the plain
     version and one library call in the same dtype: kernel 1 in f32, bf16
     and f16 (beside ``torch.addmm``; in bf16 also with A off 16 bytes, the
     element-copy route, bit for bit equal to the TMA route), kernel 2's
     partial and combine passes apart (at phase 6's block, at decode_32k's
     batch and at phase 14's decode steps, q in bf16 and 528 of 544
     positions valid: llama3.2-3b's layers and zamba2-1.2b's sites, Hkv 32,
     G 1, d 64; run after phase 14), kernel 3 in f32 and bf16 in turns with
     kernel 1;
  9. the fourth path, the factorizations (``[factor]`` lines; run after
     phase 7, before phase 8): ``ooc_cholesky`` and ``ooc_lu`` at
     n = 24576 f32 under 1 GiB (panel 2048, lookahead 1), through the entry
     point and then the schedule it plans (the budget less the panel ops'
     device workspace) on ``ScheduleExecutor`` in both modes, cold and
     warm: every result bit for bit equal, bytes against
     ``schedule_stats``, kernel 1 once per ``dgemm`` op, peak device memory
     within the budget and within the parity buffers and the panel ops'
     measured workspace (itself within what the planner charges), kernel 1
     against its plain version on the operands of every ``dgemm`` op as
     the executor stages them, a float64 Cholesky and an LU residual on the
     card, and each run's wall, transfer, panel-op, row-swap-replay and
     idle times;
 10. fault injection and recovery (``[fault]`` lines; after phase 9, on
     phase 3's and phase 9's inputs and results): ``ooc_gemm`` at 24576^3
     f32 under 2 GiB under ``FaultPlan.random(seed 0, rate 0.1)`` over
     transfer and compute faults, under an empty plan and under an oom at
     the first compute (the degrade ladder); ``ooc_cholesky`` and
     ``ooc_lu`` at n = 24576 under 1 GiB under ``FaultPlan.random(seed 0,
     rate 0.02)``, and Cholesky under an oom.  Each beside a clean run of
     the same call: every result bit for bit equal to the clean one, the
     ladders' rungs, ``last_fault_stats`` with the replayed bytes and ops
     against the plan's static derivation, nominal bytes against
     ``schedule_stats``, kernel 1's launches (one per ``dgemm`` op plus
     the replayed ones), the snapshot bytes, and peak device memory
     within the parity buffers, the snapshots and the panel ops'
     workspace (its excess over the budget printed).  Backoff sleeps are
     a no-op here.
 11. the autotuner (``[tune]`` lines; after phase 10, on phase 3's and
     phase 9's inputs and results): ``calibrate()`` on the card at its
     defaults and at the reference's sizes (both profiles beside kernel
     1's f32 and bf16 rates at the cells' block, the fingerprint twice),
     then ``tune="auto"`` with an ``AutoTuner`` on the measured profile
     and a temporary plan cache, each key searched once (its seconds
     printed) and served from the cache after: ``ooc_gemm`` 24576^3 f32
     under 2 GiB and bf16 under 1 GiB, ``ooc_syrk`` n = 16384, K = 8192
     under 1 GiB, ``ooc_cholesky`` and ``ooc_lu`` at n = 24576 under
     1 GiB (panel 2048; searched at the budget less the panel ops'
     workspace) and ``ooc_attention`` at phase 6's cell.  Each tuned call
     beside the untuned one: the plan, warm walls, the predicted makespan
     and measured/predicted, bytes against the tuned schedule's
     ``schedule_stats``, launches against its compute ops, peak memory
     over the budget; tuned MMOOC and SYRK bit for bit equal to untuned, a
     factorization at the requested panel width bit for bit equal to
     phase 9's (else held to its float64 oracle), attention to phase 6's
     tolerance.  Last, the tuned oom ladder: an oom at MMOOC's first
     compute under ``tune="auto"`` takes one ``halve_budget`` rung whose
     re-run equals a tuned run at half the budget bit for bit.
 12. hybrid co-execution (``[hybrid]`` lines; after phase 11, on phase
     3's, 4's and 6's inputs and results): the reference's member pair,
     ``DeviceSpec("gpu0", gpu_profile(), b)`` and ``DeviceSpec("phi0",
     phi_profile(), b)``, both on this card (two executors with their own
     streams, issuing from two pool threads), planned with the reference
     tests' search knobs (``nbuf_options=(1, 2), max_steps=256``; each
     plan's seconds printed).  ``run_hybrid_gemm`` at 24576^3 f32 with
     1 GiB each, cold and warm, bit for bit equal to phase 3's result,
     then with ``device_lost`` at the first compute of gpu0 and then of
     phi0 (the band rebalanced onto the survivor), bit for bit equal to
     the clean hybrid run, with ``(rebalance <dead>)`` lane groups;
     ``run_hybrid_syrk`` at n = 16384, K = 8192 with 512 MiB each, bit
     for bit equal to phase 4's result; ``run_hybrid_attention`` at phase
     6's cell with 256 MiB each, within 2e-4 of phase 6's result and of
     float64, and ``ooc_attention(devices=)``; ``ooc_cholesky(devices=)``
     at n = 8192, panel 2048, against float64 on the card and beside the
     same loop on ``backend="vmem"``.  Each call: summed bytes against
     the members' ``schedule_stats``, kernel 1's launches against the
     members' ``dgemm`` ops (plus the rebalanced band's), kernel 2's
     against twice their ``attn`` ops, peak device memory within the
     members' parity buffers (its ratio to the summed budgets printed),
     cudaMalloc calls, each member's wall, the lag, and the predicted
     makespan (canned profiles) beside the measured one.
 13. bottleneck attribution of the measured spans (``[analyze]`` lines;
     after phase 12, on the earlier phases' inputs and results): one
     extra warm call with ``record_spans=True`` per path in both executor
     modes (MMOOC 24576^3 f32 at 2 GiB and bf16 at 1 GiB, SYRK n = 16384,
     K = 8192, attention long_500k, Cholesky and LU at n = 24576 under
     1 GiB) and one hybrid MMOOC call (both members), each bit for bit
     equal to its phase's result, bytes equal to ``schedule_stats`` and
     launches to its ops; ``TraceAnalysis.from_spans`` on each, checked
     (the path runs from the first span's start to the makespan, its
     segments abut and sum to that window within the tolerance, bytes,
     flops and ops equal ``schedule_stats``) and printed: verdict,
     critical-path class shares, each stream's utilisation, the top three
     idle gaps with their causes, host staging fill beside the idle-wait
     share, the analysis's host seconds, and what the path proves about
     its idle-wait: the rule behind each path link (stream, event, engine
     or the wall-clock fallback) and the idle-wait seconds during which
     the next path op's pool was busy (engine contention) or the card was
     idle, so the host's share is given net of contention.  Then ``analyze_hybrid`` on phase
     12's plan, ``whatif_plan`` on phase 11's tuned MMOOC and SYRK plans
     under the calibrated profile, ``hclTraceAnalysis`` on one call's
     spans (equal to ``from_spans``), and ``torch.profiler`` over one more
     bf16 MMOOC ``concurrent`` call: kernel 1's device time beside the
     attribution's compute busy time, the call's Chrome trace written to
     ``chiprun_out/analyze_bf16_concurrent_trace.json``.
 14. the model zoo's serving path (``[serve]`` lines; after phase 13 has
     freed the earlier phases' tensors, each model freed before the
     next), at full width with random weights from the seed: (a)
     llama3.2-3b in float32, 28 layers, prefill of 2 x 64 tokens then 32
     teacher-forced decode steps, each step's logits within 2e-3 of
     ``forward``'s, kernel 2's passes launched 28 x 32 times each; (b) one
     bf16 decode step's attention inputs at layers 0 and 27 through kernel
     2 against its plain version and the plain mirror of the reference's
     ``decode_attention`` (phase 2's bf16 tolerance) and, with q in
     float32, at phase 6's 2e-4; (c) ``launch/serve.main`` on llama3.2-3b
     bf16 (batch 4, prompt 512, gen 32) and (d) on qwen2.5-3b (the same)
     and deepseek-moe-16b (batch 4, prompt 128, gen 8): prefill and
     decode times, tok/s, the step beside its weight-bytes floor at the
     data sheet's HBM rate, ``torch.profiler`` over a few more decode
     steps (device busy time, device ops and kernel 2's time per step),
     peak device memory against weights + cache, cudaMalloc calls over
     the decode loop, kernel 2's launches (layers x decode steps), one
     more decode step's kernel-2 inputs at the first and last layer held
     as in (b), and, for the MoE model, the share of expert assignments
     the capacity dropped, with what decides it: the plain capacity rule
     must keep the same assignments in every prefill layer, layer 0 routed
     on the CPU, on i.i.d. inputs and on the bare embeddings, and how
     alike a group's MoE inputs are.  Then the state-space families: (e)
     rwkv6-1.6b (24 layers) and zamba2-1.2b (38 Mamba2 layers, 6 shared-
     attention sites) in float32 at full depth, teacher-forced as in (a);
     (f) ``launch/serve.main`` on both in bf16 (batch 4, prompt 512, gen
     32) with the readings of (c)-(d), the step beside its floor (weights,
     the recurrent state read and written, the valid K/V), the prefill's
     device time and the costliest device ops a step.  Kernel 2 launches
     once per attention layer and decode step: every layer of a
     transformer, every site of Zamba2 (held against its plain versions
     at the first and last site), none in RWKV6.  ``forward`` runs under
     ``torch.inference_mode`` there: serving records no autograd graph.
 15. the training path (``[train]`` lines; after phase 14, each part's
     tensors freed before the next): (a) one float32 train step of
     stablelm-1.6b at full width and 2 layers (B 2, S 64, TF32 off) on the
     card against the same step on the CPU, whose path the CPU tests hold
     to the reference: the loss within 1e-5 relative, ``grad_norm`` within
     1e-4, every gradient leaf within 1e-3 of its largest magnitude, and
     ``adamw.update`` on the same gradients on both sides, the parameters
     within 1e-6; (b) ``launch/train.main`` on stablelm-1.6b at full width
     and depth (24 layers, bf16 parameters with the f32 master, remat as
     the config sets it, B 8, S 512), 3 warm steps and 10 timed: the step's
     median and spread, tokens/s, model TFLOP/s (6 N T, N the
     non-embedding parameters) and their share of the bf16 tensor-core
     peak, peak device memory beside the train state's bytes, the loss
     falling, then ``torch.profiler`` over 2 more steps (device busy share,
     device ops a step, the costliest ops) and ``adamw.update`` alone
     (its ms, device ops and bytes floor); (c) rwkv6-1.6b and zamba2-1.2b
     in bf16 at full width and depth (B 4, S 512): one warm step through
     ``launch/train.main``, one timed step under ``torch.profiler``, peak
     memory; (d) the reference test's restart at the smoke size (14 steps
     against 7, a checkpoint and 7 resumed, rtol 1e-4) under
     ``torch.use_deterministic_algorithms`` in a process of its own, with
     the save and restore seconds; (e) ``python -m
     repro_torch.examples.train_lm`` (180 M parameters, 200 steps) ending
     ``train_lm OK``.  No kernel of the three runs on this path (training
     attention is the blocked float32 attention, not kernel 2);
 16. the MESH tier and the sharded model zoo (``[mesh]`` lines; after
     phase 15, in this process on a one-rank NCCL group torn down at the
     end; one card, so no transfer between ranks happens here and the
     multi-rank rings, gathers and reductions are shown only by the CPU
     tests' gloo ranks): (a) ``ooc_gemm(backend="mesh")`` on phase 3's
     24576^3 f32 host operands, cold and warm: its wall, kernel-1
     launches (one) and P2P bytes (none), C row-sharded and bit for bit
     phase 3's result (which phase 3 and 4 hold equal to the in-core and
     vmem launches), then in bf16 on phase 7's operands, bit for bit its
     result; (b) ``direct_mesh_ooc_gemm`` on the same operands, bit for
     bit (a)'s, its wall beside; (c) ``launch/train.main --mesh on``
     (stablelm-1.6b at phase 15 (b)'s cell, 2 steps, the state DTensors
     placed by ``tree_shardings`` on a one-rank (data, model) mesh)
     beside the plain run: losses within 1e-5 relative and every updated
     parameter leaf within 1e-3 of its largest magnitude (phase 15 (a)'s
     loss and leaf bounds), the step ms of each (median of 3 more) and
     their first steps; (d) (c)'s state saved and restored onto plain
     tensors and back onto the mesh by ``tree_shardings``: checksum and
     loss on a fixed batch within ``tests/test_elastic.py``'s 1e-5 and
     1e-4, with the seconds; (e) ``compressed_pod_psum`` over a one-rank
     "pod" group on bf16 gradients of (c)'s parameter shapes, equal to a
     local quantize and dequantize exactly; (f) ``layers.local_decode`` on
     decode caches of llama3.2-3b's widths placed (Shard(0), Shard(1)) on
     a (1, 1) (data, model) mesh, so its sequence-parallel branch runs
     (kernel 2's partial pass on the rank's slice, the partials'
     all-gather, the combine pass; counted under the path
     ``seq_decode``), in bf16 and f32 against the unsplit kernel 2 within
     phase 17 (c)'s tolerances.
 17. the dry-run and sequence-parallel decode (``[dryrun]`` lines; after
     phase 16): the card's ``total_memory`` equal to the dry-run's
     ``HBM_BYTES``; (a) ``python -m repro_torch.launch.dryrun`` in a child
     process with a time limit on llama3.2-3b decode_32k at 16x16 (256
     fake ranks, fake ``cuda`` tensors; its caches' 8 KV heads do not
     divide the model axis, so every layer decodes sequence-parallel,
     kernel 2 a fake operator): status OK, the peak of live device
     storage, wire bytes by collective kind and the roofline row; (b)
     phase 15 (b)'s cell traced on a one-rank fake mesh, its flops equal
     to ``FlopCounterMode``'s count of the same step run on the card, its
     predicted peak memory and roofline bound beside phase 15's measured
     ``max_memory_allocated`` and step; (c) one llama3.2-3b decode cache
     (B 4, 544 positions, 528 valid) split into 2, 4 and 8 sequence
     slices: each slice's write and kernel-2 partial pass, the combine pass
     over their partials, against the same write and the unsplit kernel 2
     within 1e-5 in f32 and 2^-7 |want| + 1e-4 in bf16 (two roundings of
     the output at most); the fold of 2-8 slices, which phase 16 (f)'s one
     rank does not reach (its launches are kept in the part's row; the
     kernels line counts (f)'s);
 18. the paper's claims C2, C3 and C5 and its reuse claim (``[claims]``
     lines; after phase 17, on phase 11's calibrated profile; each wall
     the median of 3 timed calls after a warm one (the vendor side of
     (b): its first 3), every result bit for bit one in-core launch of
     kernel 1 on the same operands, which is held to a float32
     ``torch.addmm`` on the card within two float32 summation bounds
     (+ 2^-8 |ref| in bf16) at every size and dtype, every byte
     count ``schedule_stats``', kernel 1's launches one per ``dgemm`` op,
     peak device memory within the executor's working set or parity
     buffers; beside each wall TFLOP/s, host staging fill and wait, the
     device idle share and kernel 1's device seconds from the spans):
     (a) C2, ``ooc_gemm`` at K = 8192 under 768 MiB f32, M = N from 8192
     (in core: one launch, serial copies) to 12288, 16384 and 24576
     (out of core, 2 streams, 2 buffers) in ``concurrent`` and
     ``issue_order`` mode, then in bf16 under 384 MiB (the same plans):
     (first out-of-core - last in-core TFLOP/s) / last in-core; (b) C3 at
     M = N = 16384: ``ooc_gemm``'s plan (4 x 2) against
     ``build_vendor_schedule(tile=512)`` (one stream, one buffer, B
     re-sent for every C tile: 1024 launches) on ``HostOocRuntime``, f32
     in both modes and bf16 in ``concurrent``: vendor / library walls and
     kernel-1 device seconds, and the host time of kernel 1's wrapper a
     launch; (c) C5, (b)'s f32 call at (nstreams, nbuf) (1,1), (1,2),
     (2,2), (2,4) in ``concurrent`` mode beside the simulator's makespan
     on the calibrated profile, the claim judged at equal buffers, (1,2)
     against (2,2), then ``tune="auto"``'s pick (max_steps 256), run;
     (d) the reuse claim: a scaled block copy written as a
     ``PipelineSpec`` and one handler, 16384 x 8192 f32 under 256 MiB in
     both modes, exactly 3 X.  A claim the card does not bear out is
     printed as missed, not raised.

With ``--baseline DIR`` (another checkout, e.g. ``git archive`` of the
parent commit unpacked into a directory ``.gitignore`` lists), phase 5 is
followed by ``[base]`` lines: that tree's kernels 1 and 2, built from its
``csrc``, timed in turns with this tree's at the timing shapes (kernel 1's
f32 outputs compared bit for bit; in bf16, where the parent may sum on
the CUDA cores and this tree on the tensor cores, each within 2e-2 of the
plain version and this tree's equal to kernel 3's), and the MMOOC walls of
both in both executor modes; phase 7 adds both trees' bf16 MMOOC walls;
after phase 17, phase 14 (c)'s serving cell (llama3.2-3b bf16, batch 4,
prompt 512, gen 32, as ``launch/serve.main`` serves it) runs from each
tree in processes of their own, ten pairs in ABBA turns, each timing three
``generate`` calls after an untimed one and counting the device ops of a
decode step under ``torch.profiler``; then the host time of kernel 2's
``torch.library`` operators against their launch functions called
directly.
Without arguments it needs one card and nothing else.

The line before the last is a JSON object describing each kernel, with
each instance's launches counted by dtype on the paths above; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

SEED = 0
U32 = 2.0 ** -24          # float32 unit roundoff
# NVIDIA H100 SXM5 data sheet, dense, at the full power limit: float32
# FLOP/s on the CUDA cores, HBM3 bytes/s and bf16 FLOP/s on the tensor
# cores.  torch names the card "NVIDIA H100 80GB HBM3"; any other card
# raises.
H100_SXM = ("H100 80GB HBM3", 67e12, 3.35e12, 989e12)
SPIN_CYCLES = 2 * 10**8   # ~0.1 s at the H100's 1.98 GHz boost clock


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


def datasheet(name: str, dtype=torch.float32):
    """(peak FLOP/s for ``dtype``, peak bytes/s) of the card."""
    key, f32_flops, peak_bw, bf16_flops = H100_SXM
    if key not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}")
    return (f32_flops if dtype == torch.float32 else bf16_flops), peak_bw


def rand(shape, gen, dtype=torch.float32, device="cuda"):
    return torch.randn(shape, generator=gen, device="cuda").to(
        dtype=dtype, device=device)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time per call from CUDA events, after warm-up.  A spin
    kernel (~0.1 s) holds the stream while the host enqueues the timed
    calls, so a call that is shorter than its Python overhead is timed on
    the device and not at the pace of a busy host."""
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
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

    names = ("block_matmul", "flash_attention", "direct_vmem_gemm")
    with ThreadPoolExecutor(len(names)) as pool:
        logs = list(pool.map(_build.build, names))
    for name, log in zip(names, logs):
        say("env", f"{name}: {log['path']} built in {log['seconds']:.2f} s"
                   + (" (already built)" if log["cached"] else ""))
        for entry, usage in ptxas_usage(log["ptxas"]):
            say("build", f"{name} {entry}: {usage}")
    return line


def demangle(name: str) -> str:
    """A C++ symbol as ``c++filt`` prints it (as it is without c++filt)."""
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    return subprocess.run([tool, name], capture_output=True,
                          text=True).stdout.strip() or name


def ptxas_usage(text: str):
    """(kernel instance, "registers, spills, shared memory") per entry of
    ``ptxas -v``'s report."""
    rows, entry, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry" in ln:
            entry = demangle(ln.split(chr(39))[1]).replace(
                "(anonymous namespace)::", "").split("(")[0]
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and entry is not None:
            rows.append((entry, f"{ln.split('Used', 1)[1].strip()}; {spill}"))
            entry = None
    return rows


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
            # operands one element off a 16-byte boundary take the element
            # copies (in 16 bits, into TMA's swizzled layout): the same bits
            pad = torch.zeros(M, K + 1, dtype=dt, device="cuda")
            pad[:, 1:] = A
            require(torch.equal(block_matmul(pad[:, 1:], B, C, alpha=1.25,
                                             beta=0.5), outs[0]),
                    f"block_matmul {dt} {(M, N, K)}: unaligned A differs")
            say("kernel", f"block_matmul {str(dt)[6:]:8s} {M}x{N}x{K}: "
                          f"max err {err.max().item():.3g} "
                          f"(rtol=atol={tol}); {len(blocks)} block= "
                          f"variants, a sub-block and an unaligned A "
                          f"bitwise equal")


# the cases of tests/test_kernels.py's flash-decoding tests:
# (B, H, Hkv, d, S, block_s, lengths)
ATTN_CASES = [(1, 8, 2, 64, 512, 128, "random"),
              (2, 16, 16, 64, 1000, 256, "random"),
              (3, 8, 1, 128, 384, 128, "random"),
              (2, 4, 4, 80, 300, 128, "random"),
              (2, 8, 2, 64, 512, 128, "full"),
              (1, 4, 4, 64, 1024, 128, "short")]
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2, torch.float16: 3e-2}


def phase_kernels_attention(gen):
    from repro_torch.kernels import flash_attention as kfa

    neg_inf = torch.tensor(kfa.NEG_INF, dtype=torch.float32)
    for dt, tol in ATTN_TOL.items():
        worst = 0.0
        for B, H, hkv, d, S, bs, lens in ATTN_CASES:
            k, v = (rand((B, S, hkv, d), gen, dt) for _ in range(2))
            length = {"random": torch.randint(1, S + 1, (B,), generator=gen,
                                              device="cuda"),
                      "full": torch.full((B,), S, device="cuda"),
                      "short": torch.full((B,), 100, device="cuda")}[lens]
            length = length.to(torch.int32)
            q32 = rand((B, H, d), gen)
            for q in (q32,) if dt == torch.float32 else (q32, q32.to(dt)):
                outs = [kfa.flash_decode_attention(q, k, v, length,
                                                   block_s=bs)
                        for _ in range(2)]
                ref = kfa.flash_decode_attention_plain(q, k, v, length,
                                                       block_s=bs)
                torch.cuda.synchronize()
                err = (outs[0].float() - ref.float()).abs()
                require(outs[0].dtype == q.dtype
                        and bool((err <= tol + tol * ref.float().abs())
                                 .all()),
                        f"flash_attention {dt} q {q.dtype} "
                        f"{(B, H, hkv, d, S, bs)}: max err "
                        f"{err.max().item()} beyond rtol=atol={tol}")
                require(torch.equal(outs[0], outs[1]),
                        f"flash_attention {dt} {(B, H, hkv, d, S, bs)}: two "
                        f"runs differ")
                worst = max(worst, err.max().item())
                if lens == "short":
                    m, l, acc = kfa.flash_partial(q, k, v, length,
                                                  block_s=bs)
                    require(bool((m[:, :, 1:].cpu() == neg_inf).all())
                            and not bool(l[:, :, 1:].any())
                            and not bool(acc[:, :, 1:].any()),
                            f"flash_attention {dt}: a fully masked split is "
                            f"not exactly (NEG_INF, 0, 0)")
                    trunc = kfa.flash_decode_attention_plain(
                        q, k[:, :100], v[:, :100], length, block_s=bs)
                    terr = (outs[0].float() - trunc.float()).abs().max()
                    require(terr.item() <= tol,
                            f"flash_attention {dt}: masked cache differs from "
                            f"the truncated one by {terr.item()}")
        # a row of length 0 gives zeros
        q = rand((2, 8, 64), gen)
        k, v = rand((2, 512, 2, 64), gen, dt), rand((2, 512, 2, 64), gen, dt)
        out = kfa.flash_decode_attention(
            q, k, v, torch.tensor([300, 0], dtype=torch.int32,
                                  device="cuda"), block_s=128)
        require(not bool(out[1].any()) and bool(torch.isfinite(out).all()),
                f"flash_attention {dt}: a row of length 0 is not all zeros")
        say("kernel", f"flash_attention KV {str(dt)[6:]:8s}: "
                      f"{len(ATTN_CASES)} shapes x q in f32 and "
                      f"{str(dt)[6:]}, max err vs plain {worst:.3g} "
                      f"(rtol=atol={tol}); ragged lengths, masked split "
                      f"exactly (NEG_INF, 0, 0) and == truncated cache, "
                      f"length 0 -> zeros, two runs bitwise equal")


# tests/test_kernels.py's block GEMM shapes, a ragged one, 256-multiples
DIRECT_SHAPES = [(128, 128, 128), (256, 384, 512), (300, 200, 150),
                 (512, 128, 257), (64, 64, 64), (1000, 999, 1001),
                 (512, 768, 256)]


def phase_kernels_direct(gen):
    from repro_torch import direct_impls as D
    from repro_torch.kernels.block_matmul import block_matmul

    tols = {torch.float32: 2e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
    blocks = [(256, 256, 256), (128, 64, 32), (64, 128, 16), (64, 64, 64)]
    saved = (D.direct_vmem_ooc_gemm.launches, block_matmul.launches)
    for dt, tol in tols.items():
        worst = 0.0
        for M, N, K in DIRECT_SHAPES:
            A, B, C = (rand(s, gen, dt) for s in ((M, K), (K, N), (M, N)))
            C0 = C.clone()
            outs = [D.direct_vmem_ooc_gemm(A, B, C, 1.25, 0.5, block=blk)
                    for blk in blocks]
            again = D.direct_vmem_ooc_gemm(A, B, C, 1.25, 0.5)
            ref = D.direct_vmem_ooc_gemm_plain(A, B, C, 1.25, 0.5)
            k1 = block_matmul(A, B, C, alpha=1.25, beta=0.5)
            torch.cuda.synchronize()
            err = (outs[0].float() - ref.float()).abs()
            require(outs[0].dtype == dt
                    and bool((err <= tol + tol * ref.float().abs()).all()),
                    f"direct_vmem_gemm {dt} {(M, N, K)}: max err "
                    f"{err.max().item()} beyond rtol=atol={tol}")
            require(all(torch.equal(outs[0], o) for o in outs[1:] + [again]),
                    f"direct_vmem_gemm {dt} {(M, N, K)}: block= variants or "
                    f"two launches differ")
            require(torch.equal(C, C0), f"direct_vmem_gemm {dt}: C changed")
            worst = max(worst, err.max().item())
            require(torch.equal(outs[0], k1),
                    f"direct_vmem_gemm {dt} {(M, N, K)}: kernel 3 differs "
                    f"from kernel 1 (max "
                    f"{(outs[0].float() - k1.float()).abs().max().item()})")
        say("direct", f"direct_vmem_gemm {str(dt)[6:]:8s}: "
                      f"{len(DIRECT_SHAPES)} shapes, max err vs plain "
                      f"{worst:.3g} (rtol=atol={tol}); {len(blocks)} block= "
                      f"variants and a second launch bitwise equal; C "
                      f"unchanged; kernel 3 == kernel 1 bitwise")
    D.direct_vmem_ooc_gemm.launches, block_matmul.launches = saved


def dgemm_ops(sched) -> int:
    from repro_torch.core import BlockRef, OpKind

    return sum(1 for op in sched.ops if op.kind == OpKind.COMPUTE
               and isinstance(op.payload, BlockRef)
               and op.payload.kernel == "dgemm")


def zero_counts(*wrappers):
    """Sets kernel wrappers' launch counts, total and by dtype, to 0."""
    for w in wrappers:
        w.launches, w.launches_by_dtype = 0, {}


def read_counts(wrapper, report, key, add=False):
    """Keeps the launches of ``wrapper`` on one path (total and by dtype)
    under ``key``, or with ``add`` adds them to what ``key`` holds, and
    returns the wrapper's total."""
    if not add or key not in report["launches"]:
        report["launches"][key], report["launches_by_dtype"][key] = 0, {}
    report["launches"][key] += wrapper.launches
    by = report["launches_by_dtype"][key]
    for dt, n in wrapper.launches_by_dtype.items():
        by[dt] = by.get(dt, 0) + n
    return wrapper.launches


def mmooc_modes(A, B, C, params, sched, report, phase, key):
    """``ooc_gemm`` host backend on host operands in both executor modes,
    cold then warm: launches, bytes against ``schedule_stats`` and peak
    device memory checked, each run's row kept in ``report["main_path"]``
    (the warm one with device busy by engine, H2D/D2H GB/s over copy time
    and the device's idle share).  The cold issue_order run's launches are
    kept under ``key``.  Returns the cold results by mode."""
    from repro_torch.core import (HostOocRuntime, OpKind, ScheduleExecutor,
                                  ooc_gemm, schedule_stats)
    from repro_torch.kernels.block_matmul import block_matmul

    alpha, beta, budget, part = params
    stats = schedule_stats(sched)
    n_dgemm = dgemm_ops(sched)
    ws = part.working_set_bytes(nbuf=2, nstreams=2)
    slack = 64 * 2**20
    outs = {}
    for mode in ("issue_order", "concurrent"):
        ex = ScheduleExecutor(mode=mode)
        rt = HostOocRuntime(executor=ex)
        for rep in ("cold", "warm"):
            ex.record_spans = rep == "warm"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            zero_counts(block_matmul)
            out = ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget,
                           backend="host", nstreams=2, nbuf=2, runtime=rt)
            launches = block_matmul.launches
            if (mode, rep) == ("issue_order", "cold"):
                read_counts(block_matmul, report, key)
            peak = torch.cuda.max_memory_allocated() - base
            require(launches == n_dgemm,
                    f"{phase} {mode}: {launches} kernel launches, expected "
                    f"{n_dgemm} (one per dgemm op)")
            require(ex.last_h2d_bytes == stats["h2d_bytes"]
                    and ex.last_d2h_bytes == stats["d2h_bytes"],
                    f"{phase} {mode}: moved {ex.last_h2d_bytes}/"
                    f"{ex.last_d2h_bytes} B, schedule_stats says "
                    f"{stats['h2d_bytes']}/{stats['d2h_bytes']}")
            require(peak <= ws + slack,
                    f"{phase} {mode}: peak device memory {peak} B above the "
                    f"working set {ws} B + {slack} B slack")
            wall = ex.last_wall_seconds
            row = {"dtype": str(A.dtype)[6:], "mode": mode, "run": rep,
                   "wall_s": wall, "tflops": stats["flops"] / wall / 1e12,
                   "launches": launches, "peak_bytes": peak,
                   "h2d_bytes": ex.last_h2d_bytes,
                   "d2h_bytes": ex.last_d2h_bytes,
                   "stage_s": ex.last_stage_seconds}
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
            say(phase, f"{mode:11s} {rep}: {wall:.3f} s wall, "
                       f"{row['tflops']:.2f} TFLOP/s effective, "
                       f"{launches} launches, bytes = schedule_stats, "
                       f"peak {peak / 2**30:.3f} GiB <= working set "
                       f"{ws / 2**30:.3f} GiB + 64 MiB slack (allocator "
                       f"rounding); host staging fill "
                       f"{ex.last_stage_seconds:.3f} s"
                       + (f", device busy {json.dumps(row['device_busy_s'])}"
                          f" s, H2D {row['h2d_gbps']:.1f} GB/s, D2H "
                          f"{row['d2h_gbps']:.1f} GB/s over device copy "
                          f"time, device idle "
                          f"{100 * row['device_idle_share']:.1f} % of the "
                          f"wall" if "h2d_gbps" in row else ""))
            if rep == "cold":
                outs[mode] = out
            del out
    require(torch.equal(outs["issue_order"], outs["concurrent"]),
            f"{phase}: issue_order and concurrent results differ")
    say(phase, "issue_order == concurrent, bitwise")
    return outs


def in_core_equal(A, B, C, alpha, beta, host_out, report, key, phase):
    """One launch of kernel 1 on the whole problem equals the out-of-core
    result bit for bit (the partition invariant)."""
    from repro_torch.core import ooc_gemm
    from repro_torch.kernels.block_matmul import block_matmul

    zero_counts(block_matmul)
    incore = ooc_gemm(A, B, C, alpha, beta, budget_bytes=1 << 40,
                      backend="host")
    require(read_counts(block_matmul, report, key) == 1,
            f"{phase}: in-core path is not one launch")
    require(torch.equal(incore, host_out),
            f"{phase}: out-of-core result differs from the in-core launch")
    say(phase, "out-of-core == in-core (one launch on the whole problem), "
               "bitwise")


def phase_main(gen, report):
    from repro_torch.core import (build_gemm_schedule, plan_gemm_partition,
                                  schedule_stats)

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
    say("main", f"partition {part.h}x{part.w} of {part.bm}x{part.bn} blocks; "
                f"schedule_stats {json.dumps(schedule_stats(sched))}; "
                f"{dgemm_ops(sched)} dgemm ops; working set (nbuf=2) "
                f"{part.working_set_bytes(nbuf=2, nstreams=2)} B")
    outs = mmooc_modes(A, B, C, (alpha, beta, budget, part), sched, report,
                       "main", "host")
    host_out = outs.pop("issue_order")
    outs.clear()
    in_core_equal(A, B, C, alpha, beta, host_out, report, "in_core", "main")

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


# the bf16 MMOOC plan at 24576^3 under 1 GiB (= the f32 cell's at 2 GiB)
BF16_H2D, BF16_D2H = 7_247_757_312, 1_207_959_552


def phase_main_bf16(gen, report, base=None):
    """MMOOC in bf16: the f32 cell's plan at half the bytes, with kernel 1
    on the tensor cores.  With ``base`` (another checkout), both trees'
    warm walls in turns.  Returns the operands and the result."""
    from repro_torch.core import (build_gemm_schedule, plan_gemm_partition,
                                  schedule_stats)

    M = N = K = 24576
    budget = 2**30
    alpha, beta = 1.5, 0.5
    dt = torch.bfloat16
    t0 = time.perf_counter()
    A, B, C = (rand(s, gen, dt, device="cpu")
               for s in ((M, K), (K, N), (M, N)))
    part = plan_gemm_partition(M, N, K, budget, 2)
    sched = build_gemm_schedule(part, nstreams=2, nbuf=2)
    stats = schedule_stats(sched)
    require((part.h, part.w, part.bm, part.bn, dgemm_ops(sched))
            == (4, 4, 6144, 6144, 16)
            and (stats["h2d_bytes"], stats["d2h_bytes"])
            == (BF16_H2D, BF16_D2H),
            f"bf16 plan {part.h}x{part.w} of {part.bm}x{part.bn}, stats "
            f"{stats}")
    say("bf16", f"host operands {M}^3 bf16 made from seed {SEED} in "
                f"{time.perf_counter() - t0:.1f} s, "
                f"{3 * M * K * 2 / budget:.2f}x the 1 GiB budget; partition "
                f"4x4 of 6144x6144 blocks, 16 dgemm ops; schedule_stats "
                f"{json.dumps(stats)}; working set (nbuf=2) "
                f"{part.working_set_bytes(nbuf=2, nstreams=2)} B")
    outs = mmooc_modes(A, B, C, (alpha, beta, budget, part), sched, report,
                       "bf16", "host_bf16")
    host_out = outs.pop("issue_order")
    outs.clear()
    in_core_equal(A, B, C, alpha, beta, host_out, report, "in_core_bf16",
                  "bf16")
    Ad, Bd, Cd = (t.cuda().float() for t in (A, B, C))
    ref = torch.addmm(Cd, Ad, Bd, beta=beta, alpha=alpha)
    del Ad, Bd, Cd
    err = (host_out.cuda().float() - ref).abs()
    require(bool((err <= 2e-2 + 2e-2 * ref.abs()).all()),
            f"bf16 MMOOC: max err {err.max().item()} vs float32 addmm beyond "
            f"rtol=atol=2e-2")
    say("bf16", f"vs float32 torch.addmm on the card (oracle): max abs err "
                f"{err.max().item():.4g} beside max |ref| "
                f"{ref.abs().max().item():.4g}, within rtol=atol=2e-2; "
                f"finite {bool(torch.isfinite(host_out).all())}")
    del ref, err
    if base is not None:
        csrc = os.path.join(os.path.abspath(base), "src", "repro_torch",
                            "csrc")
        report["baseline_bf16"] = mmooc_turns(A, B, C, (alpha, beta, budget),
                                              csrc)
    return A, B, C, host_out


# the shared planner's factor plans (factor_pipeline_spec, equal to the
# reference's) at n = 24576 f32 under 1 GiB, panel 2048, lookahead 1, 2
# streams, 2 buffers (schedule_stats of the compiled schedule): panels,
# ops, dgemm ops, H2D bytes, D2H bytes.  The entry points plan the same
# call against the budget less the panel ops' device workspace.
FACTOR_N, FACTOR_PANEL, FACTOR_BUDGET = 24576, 2048, 2**30
FACTOR_PLANS = {"cholesky": (12, 291, 59, 9_539_944_448, 6_960_447_488),
                "lu": (12, 762, 166, 15_535_702_016, 10_905_190_400)}
PANEL_TAGS = ("POTRF", "GETRF", "TRSM")


def factor_input(gen, kind, n):
    """The factorization's input, made on the card from the seed and copied
    to the host: ``M M^T / n + I`` (SPD, eigenvalues about 1-5, built with
    kernel 1, whose fixed k order makes it exactly symmetric) for
    Cholesky, a standard-normal M for LU (so pivoting swaps rows)."""
    from repro_torch.kernels.block_matmul import block_matmul

    M = torch.randn((n, n), generator=gen, device="cuda")
    if kind == "cholesky":
        M = block_matmul(M, M.T.contiguous(), torch.eye(n, device="cuda"),
                         alpha=1.0 / n, beta=1.0)
    return M.cpu()


def panel_workspace(kind, n, pw):
    """Device bytes the panel ops allocate beyond their buffers at the
    largest panel (n x pw), as the handlers run them: the solver's copy,
    and the libraries' own workspace for a stream they have not run on
    (the panel stream of a ``concurrent`` run is such a stream; cuBLAS
    keeps one workspace a stream)."""
    from repro_torch.core import runtime as rt

    pnl = torch.randn((n, pw), device="cuda")
    pnl[:pw] += n * torch.eye(pw, device="cuda")   # SPD head, pivots in it
    urow = torch.randn((pw, n - pw), device="cuda")
    fresh = torch.cuda.Stream()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.cuda.stream(fresh), rt.prefer_cusolver(pnl.device):
        if kind == "cholesky":
            L, info = torch.linalg.cholesky_ex(pnl[:pw, :pw])
            pnl[:pw, :pw] = L
            del L, info
            rt.chol_panel_solve(pnl)
        else:
            piv = rt.getrf_panel(pnl)
            rt.lu_row_solve(pnl, urow)
            del piv
    torch.cuda.synchronize()
    ws = torch.cuda.max_memory_allocated() - base
    del pnl, urow
    return ws


def panel_op_ms(kind, n, pw):
    """Device ms of each panel op at the largest panel (n x pw): POTRF and
    the Cholesky TRSM, or GETRF and the LU row TRSM, the TRSMs in place as
    the handlers run them.  GETRF is timed through cuSOLVER, which the
    executor asks for, and through PyTorch's default choice (MAGMA for a
    tall panel)."""
    pnl = torch.randn((n, pw), device="cuda")
    pnl[:pw] += n * torch.eye(pw, device="cuda")
    urow = torch.randn((pw, n - pw), device="cuda")
    L = torch.linalg.cholesky(pnl[:pw, :pw])
    la = torch.linalg
    prev = torch.backends.cuda.preferred_linalg_library()
    ms = {}
    try:
        for lib in ("cusolver", "default"):
            torch.backends.cuda.preferred_linalg_library(lib)
            if kind == "cholesky":
                if lib == "cusolver":
                    head = pnl[:pw, :pw]
                    ms["potrf"] = time_ms(lambda: la.cholesky_ex(head))
                    rows = pnl[pw:]
                    ms["trsm"] = time_ms(lambda: la.solve_triangular(
                        L.T, rows, upper=True, left=False, out=rows))
            else:
                ms[f"getrf_{lib}"] = time_ms(lambda: la.lu_factor_ex(pnl),
                                             reps=3)
                if lib == "cusolver":
                    ms["trsm"] = time_ms(lambda: la.solve_triangular(
                        L, urow, upper=False, left=True, unitriangular=True,
                        out=urow))
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
    return ms


def factor_row(kind, sched, stats, ex, wall, mallocs, peak, n):
    """One run's figures from its CUDA-event spans and counters.  An LU
    write-back's span (the finalizer) runs from its panel copy to the end
    of the host's replay and landing, so it is kept apart: not in D2H busy
    and not in the device's busy union."""
    from repro_torch.core import BlockRef, OpKind

    busy, panel_s, dgemm_s, wb_s, wb_bytes = {}, 0.0, 0.0, 0.0, 0
    device = []
    for op, span in zip(sched.ops, ex.last_spans):
        tag, _, t0, t1 = span
        if op.kind == OpKind.D2H and isinstance(op.payload, BlockRef):
            wb_s += t1 - t0
            wb_bytes += op.bytes
            continue
        device.append(span)
        busy[op.kind] = busy.get(op.kind, 0.0) + t1 - t0
        if tag.startswith(PANEL_TAGS):
            panel_s += t1 - t0
        elif tag.startswith(("SYRK", "GEMM")):
            dgemm_s += t1 - t0
    covered, reach = 0.0, 0.0   # union of the op spans
    for _, _, t0, t1 in sorted(device, key=lambda x: x[2]):
        covered += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    flops = n ** 3 / 3 if kind == "cholesky" else 2 * n ** 3 / 3
    return {"kind": kind, "wall_s": wall, "useful_tflops": flops / wall / 1e12,
            "h2d_busy_s": busy[OpKind.H2D], "d2h_busy_s": busy[OpKind.D2H],
            "h2d_gbps": stats["h2d_bytes"] / busy[OpKind.H2D] / 1e9,
            "d2h_gbps": (stats["d2h_bytes"] - wb_bytes)
            / busy[OpKind.D2H] / 1e9, "writeback_s": wb_s,
            "compute_busy_s": busy[OpKind.COMPUTE], "dgemm_busy_s": dgemm_s,
            "panel_ops_s": panel_s, "stage_s": ex.last_stage_seconds,
            "row_swap_replay_s": ex.last_handler_seconds.get(
                "row_swap_replay", 0.0),
            "device_idle_share": 1.0 - covered / wall,
            "peak_bytes": peak, "cuda_mallocs": mallocs}


def check_dgemm_ops(sched, A, ctx, kind, first):
    """Kernel 1 against its plain version on the operands that every
    ``dgemm`` op of ``sched`` reads, staged as the executor stages them
    (Cholesky's transposed ``Ft`` slices through the tiled fill), at
    alpha = -1, beta = 1: each result within twice f32's summation bound of
    the plain one, ``gemm_err``'s criterion.  A run of its own after the
    timed ones (its launches are not the path's); its result must equal
    theirs bit for bit.  Returns (ops checked, their shapes, max |err|,
    max err / bound)."""
    from repro_torch.core import ScheduleExecutor
    from repro_torch.kernels.block_matmul import block_matmul, \
        block_matmul_plain

    alpha, beta = ctx["alpha"], ctx["beta"]
    errs, ratios, shapes = [], [], set()

    def dgemm(st, op, ref):
        a, b = (st.bufs[k] for k in op.buffers_read)
        c = st.bufs[op.buffers_written[0]]
        c0 = c.clone()
        block_matmul(a, b, c, alpha=alpha, beta=beta, out=c)
        want = block_matmul_plain(a, b, c0, alpha=alpha, beta=beta)
        err = (c - want).abs().double()
        bound = 2 * sum_tol(a, b, c0, alpha, beta)
        errs.append(err.max())
        ratios.append((err / bound.clamp_min(1e-300)).max())
        shapes.add((a.shape[0], b.shape[1], a.shape[1]))

    ex = ScheduleExecutor(mode="issue_order", handlers={"dgemm": dgemm})
    out = A.clone()
    st = ex.run(sched, {}, {"A": out}, ctx)
    res = (torch.tril(out),) if kind == "cholesky" \
        else (out, st.scratch["perm"])
    require(all(torch.equal(a, b) for a, b in zip(res, first)),
            f"{kind}: the checking run differs from the entry point's")
    err = torch.stack(errs).max().item()
    ratio = torch.stack(ratios).max().item()
    require(ratio <= 1.0,
            f"{kind}: kernel 1 on a dgemm op's operands differs from the "
            f"plain version by {ratio:.3g} x 2 sqrt(K) u sum|terms|")
    return len(errs), sorted(shapes, key=math.prod, reverse=True), err, \
        ratio


def factor_case(gen, report, kind):
    """``ooc_cholesky`` or ``ooc_lu`` at n = 24576 f32 under 1 GiB through
    the entry point, then the schedule it plans on ``ScheduleExecutor`` in
    both modes, cold and warm: every result bit for bit equal, bytes equal
    to ``schedule_stats``, kernel 1 once per ``dgemm`` op, peak device
    memory within the budget and within the parity buffers and the panel
    ops' workspace, kernel 1 against its plain version on every ``dgemm``
    op's operands, and a float64 oracle on the card.  Kernel 1's launches
    on the entry point's run are kept as the path's."""
    from repro_torch.core import (BlockRef, ScheduleExecutor,
                                  compile_factor_pipeline,
                                  factor_pipeline_spec, ooc_cholesky, ooc_lu,
                                  schedule_stats)
    from repro_torch.core.ooc_factor import (_plan_factor_spec,
                                             panel_workspace_bytes)
    from repro_torch.kernels.block_matmul import block_matmul

    n, pw, budget = FACTOR_N, FACTOR_PANEL, FACTOR_BUDGET
    t0 = time.perf_counter()
    A = factor_input(gen, kind, n)

    def plan_of(spec):
        sched = compile_factor_pipeline(spec, nstreams=2, nbuf=2)
        stats = schedule_stats(sched)
        return sched, stats, (spec.npanels, stats["n_ops"], dgemm_ops(sched),
                              stats["h2d_bytes"], stats["d2h_bytes"])

    shared = factor_pipeline_spec(n, pw, budget, 4, kind=kind, lookahead=1,
                                  nbuf=2)
    plan = plan_of(shared)[2]
    require(plan == FACTOR_PLANS[kind],
            f"{kind} plan (panels, ops, dgemm, H2D, D2H) {plan}, expected "
            f"{FACTOR_PLANS[kind]}")
    charged = panel_workspace_bytes(kind, n, pw, 4, "cuda")
    spec = _plan_factor_spec(kind, n, pw, budget, 4, 1, 2, "cuda")
    sched, stats, run_plan = plan_of(spec)
    n_dgemm = run_plan[2]
    panel_ops = sum(1 for op in sched.ops if isinstance(op.payload, BlockRef)
                    and op.payload.kernel != "dgemm")
    ws = panel_workspace(kind, n, pw)
    require(ws <= charged,
            f"{kind}: the panel ops took {ws} B of device workspace, the "
            f"planner charges {charged} B")
    op_ms = panel_op_ms(kind, n, pw)
    report["factor_panel_ms"][kind] = op_ms
    say("factor", f"{kind}: A {n}x{n} f32 ({A.nbytes / 2**30:.2f} GiB, "
                  f"{A.nbytes / budget:.2f}x the 1 GiB budget) made on the "
                  f"card from seed {SEED} in {time.perf_counter() - t0:.1f} "
                  f"s; panel {pw}, lookahead 1, nstreams 2, nbuf 2; the "
                  f"shared planner at 1 GiB: {plan[0]} panels, {plan[1]} "
                  f"ops, {plan[2]} dgemm ops (trailing blocks {shared.bm}x"
                  f"{shared.bn}), {plan[3]} B H2D, {plan[4]} B D2H (= "
                  f"schedule_stats); the entry point's plan, at the budget "
                  f"less {charged} B charged for the panel ops: "
                  f"{run_plan[0]} panels, lookahead {spec.lookahead}, "
                  f"{run_plan[1]} ops, {n_dgemm} dgemm ops (trailing blocks "
                  f"{spec.bm}x{spec.bn}), {panel_ops} panel ops, "
                  f"{run_plan[3]} B H2D, {run_plan[4]} B D2H; panel ops' "
                  f"workspace at the largest panel, measured on a fresh "
                  f"stream, {ws} B <= {charged} B charged; there: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in op_ms.items())
                  + (" (getrf_default: PyTorch's default backend, not used)"
                     if kind == "lu" else ""))
    ctx = {"alpha": -1.0, "beta": 1.0, "panel": spec.panel, "n": spec.n}
    entry = ooc_cholesky if kind == "cholesky" else ooc_lu
    first = None
    slack = 32 * 2**20          # allocator rounding of ~10 buffers
    for mode, rep in (("entry point", "cold"), ("issue_order", "cold"),
                      ("issue_order", "warm"), ("concurrent", "cold"),
                      ("concurrent", "warm")):
        if rep == "cold":
            ex = ScheduleExecutor(mode=mode.replace("entry point",
                                                    "issue_order"),
                                  record_spans=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mallocs = torch.cuda.memory_stats()["num_device_alloc"]
        zero_counts(block_matmul)
        if mode == "entry point":
            res = entry(A, pw, budget_bytes=budget, lookahead=1, nstreams=2,
                        nbuf=2, executor=ex)
            read_counts(block_matmul, report, kind)
        else:
            out = A.clone()
            st = ex.run(sched, {}, {"A": out}, ctx)
            res = torch.tril(out) if kind == "cholesky" \
                else (out, st.scratch["perm"])
            del out, st
        n_k1 = block_matmul.launches
        peak = torch.cuda.max_memory_allocated() - base
        mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
        res = res if isinstance(res, tuple) else (res,)
        require(n_k1 == n_dgemm,
                f"{kind} {mode}: {n_k1} kernel-1 launches, expected "
                f"{n_dgemm} (one per dgemm op)")
        require((ex.last_h2d_bytes, ex.last_d2h_bytes)
                == (stats["h2d_bytes"], stats["d2h_bytes"]),
                f"{kind} {mode}: moved {ex.last_h2d_bytes}/"
                f"{ex.last_d2h_bytes} B, schedule_stats says "
                f"{stats['h2d_bytes']}/{stats['d2h_bytes']}")
        parity = ex.last_buffer_bytes
        require(peak <= parity + ws + slack,
                f"{kind} {mode}: peak device memory {peak} B above the "
                f"parity buffers {parity} B + panel workspace {ws} B + "
                f"{slack} B")
        require(peak <= budget,
                f"{kind} {mode}: peak device memory {peak} B above the "
                f"budget of {budget} B")
        if first is None:
            first = res
        else:
            require(all(torch.equal(a, b) for a, b in zip(res, first)),
                    f"{kind} {mode} {rep}: differs from the entry point's "
                    f"result")
        row = factor_row(kind, sched, stats, ex, ex.last_wall_seconds,
                         mallocs, peak, n)
        row.update(mode=mode, run=rep, launches=n_k1, parity_bytes=parity,
                   workspace_bytes=ws, charged_bytes=charged)
        report["factor"].append(row)
        say("factor", f"{kind} {mode:11s} {rep}: {row['wall_s']:.3f} s wall, "
                      f"{row['useful_tflops']:.2f} TFLOP/s useful "
                      f"({'n^3/3' if kind == 'cholesky' else '2n^3/3'}), "
                      f"{n_k1} kernel-1 launches, bytes = schedule_stats; "
                      f"H2D busy {row['h2d_busy_s']:.3f} s "
                      f"({row['h2d_gbps']:.1f} GB/s), D2H busy "
                      f"{row['d2h_busy_s']:.3f} s ({row['d2h_gbps']:.1f} "
                      f"GB/s); dgemm busy {row['dgemm_busy_s']:.3f} s, panel "
                      f"ops (POTRF/GETRF/TRSM) {row['panel_ops_s']:.4f} s, "
                      f"row-swap replay {row['row_swap_replay_s']:.4f} s "
                      f"(host)"
                      + (f" in LU write-back spans of {row['writeback_s']:.3f}"
                         f" s (panel copy, replay, landing)"
                         if kind == "lu" else "")
                      + f"; host staging fill {row['stage_s']:.3f} s; "
                      f"device idle {100 * row['device_idle_share']:.1f} % "
                      f"of the wall; peak {peak} B <= parity {parity} B + "
                      f"workspace {ws} B + 32 MiB, {peak / budget:.3f}x "
                      f"the 1 GiB budget; {mallocs} cudaMalloc")
        del res
    say("factor", f"{kind}: entry point, issue_order and concurrent, cold "
                  f"and warm: all five results bitwise equal")
    checked, shapes, err, ratio = check_dgemm_ops(sched, A, ctx, kind, first)
    report["factor_dgemm_check"][kind] = {
        "ops": checked, "shapes": shapes[:4], "max_abs_err": err,
        "max_err_over_bound": ratio}
    require(checked == n_dgemm, f"{kind}: checked {checked} of {n_dgemm} "
                                f"dgemm ops")
    say("factor", f"{kind}: kernel 1 vs block_matmul_plain on the operands "
                  f"of all {checked} dgemm ops as the executor stages them "
                  f"(alpha -1, beta 1; largest (M, N, K) {shapes[0]}): max "
                  f"|err| {err:.3g}, max err / (2 sqrt(K) u sum|terms|) "
                  f"{ratio:.3g} (limit 1); the checking run == the timed "
                  f"runs bitwise")
    factor_oracle(kind, A, first, n)
    return A, first


def factor_oracle(kind, A, res, n):
    """Cholesky: float64 ``torch.linalg.cholesky`` of the whole matrix on
    the card, within ``tests/test_factor.py``'s 5e-6 of the factor's
    largest entry.  LU: ``perm`` a permutation, every multiplier within
    1 + 1e-6, and on 256 sampled rows, in float64 on the card,
    ``|A[perm] - L U| <= sqrt(n) u (|L| |U|)`` elementwise (LU's backward
    error bound, Higham, Accuracy and Stability of Numerical Algorithms,
    2nd ed., theorem 9.3, with the probabilistic sqrt(n) u for n u)."""
    if kind == "cholesky":
        exact = torch.linalg.cholesky(A.cuda().double())
        L = res[0].cuda().double()
        require(bool(torch.isfinite(L).all()), "cholesky: factor not finite")
        scale = exact.abs().max().item()
        err = (L - exact).abs().max().item() / scale
        del exact, L
        require(err <= 5e-6, f"cholesky: max |L - L64| / max |L64| = {err} "
                             f"beyond 5e-6")
        say("factor", f"cholesky vs float64 torch.linalg.cholesky on the "
                      f"card: max |L - L64| / max |L64| = {err:.3g} (limit "
                      f"5e-6, tests/test_factor.py); max |L64| {scale:.4g}")
        return
    LU, perm = res
    require(bool(torch.equal(perm.sort().values, torch.arange(n))),
            "lu: perm is not a permutation")
    swapped = int((perm != torch.arange(n)).sum())
    LUd = LU.cuda()
    require(bool(torch.isfinite(LUd).all()), "lu: factor not finite")
    lmax = torch.tril(LUd, -1).abs().max().item()
    require(lmax <= 1.0 + 1e-6, f"lu: a multiplier of {lmax} beyond 1 + 1e-6")
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))[
        :256].sort().values
    U = torch.triu(LUd.double())
    rows_d = rows.cuda()
    cols = torch.arange(n, device="cuda")
    Lr = torch.where(cols < rows_d[:, None], LUd[rows_d].double(), 0.0)
    Lr[torch.arange(256, device="cuda"), rows_d] = 1.0
    del LUd
    prod = Lr @ U
    bound = math.sqrt(n) * U32 * (Lr.abs() @ U.abs())
    del U
    Ar = A[perm[rows]].cuda().double()
    err = (Ar - prod).abs()
    ratio = (err / bound).max().item()
    rel = err.max().item() / A.abs().max().item()
    require(ratio <= 1.0, f"lu: sampled rows |A[perm] - LU| up to {ratio:.3g}"
                          f" x sqrt(n) u (|L||U|)")
    say("factor", f"lu: perm a permutation moving {swapped} of {n} rows; "
                  f"max multiplier {lmax:.6f} (limit 1 + 1e-6); 256 sampled "
                  f"rows in float64 on the card: max |A[perm] - L U| / "
                  f"(sqrt(n) u (|L||U|)) = {ratio:.3g} (limit 1), normwise "
                  f"max |A[perm] - LU| / max |A| = {rel:.3g}")


def phase_factor(gen, report):
    """Phase 9: the factorizations on the card; returns each one's input
    and result by kind."""
    return {kind: factor_case(gen, report, kind)
            for kind in ("cholesky", "lu")}


# ---------------------------------------------------------------------------
# Phase 10: fault injection and recovery on the main paths ([fault] lines)
# ---------------------------------------------------------------------------
MMOOC_FAULT_RATE, FACTOR_FAULT_RATE = 0.1, 0.02


class FaultCapture:
    """A ``faults=`` factory: draws ``FaultPlan.random(seed, sched, rate)``
    (or, with ``oom``, one oom at the first compute op) on the schedule the
    entry point builds, and keeps that schedule and the injector."""

    def __init__(self, seed=0, rate=0.0, oom=False):
        self.seed, self.rate, self.oom = seed, rate, oom
        self.sched = self.inj = None

    def __call__(self, sched):
        from repro_torch.core import OpKind
        from repro_torch.fault import FaultPlan, FaultSpec

        self.sched = sched
        if self.oom:
            first = next(i for i, op in enumerate(sched.ops)
                         if op.kind == OpKind.COMPUTE)
            plan = FaultPlan(specs=(FaultSpec(op=first, cls="oom"),))
        else:
            plan = FaultPlan.random(self.seed, sched, self.rate)
        self.inj = plan.injector()
        return self.inj


def replayed_dgemms(sched, injected):
    """Kernel 1's launches beyond one per ``dgemm`` op: the ``dgemm`` ops
    of the redo-set of each injected compute fault (its faulted attempt
    and the chain re-run before its clean one)."""
    from repro_torch.fault import redo_set

    return sum(sum(1 for j in redo_set(sched, i)
                   if sched.ops[j].payload.kernel == "dgemm")
               for i, cls in injected if cls == "compute_nan")


def check_faulted(tag, ex, cap, launches, peak, extra_bytes, budget,
                  clean_wall, report):
    """The checks every faulted run must pass, and its ``[fault]`` line:
    ``replayed_h2d_bytes`` and ``replayed_ops`` against the static
    derivation from the plan, the nominal bytes against ``schedule_stats``,
    kernel 1's launches (one per ``dgemm`` op plus the replayed ones) and
    peak device memory within the parity buffers, the snapshots and
    ``extra_bytes`` (the panel ops' workspace)."""
    from repro_torch.core import OpKind, schedule_stats
    from repro_torch.fault import redo_set

    sched, injected = cap.sched, cap.inj.injected
    fs = ex.last_fault_stats
    stats = schedule_stats(sched)
    want_h2d = sum(sched.ops[i].bytes for i, c in injected
                   if c == "h2d_error" and sched.ops[i].kind == OpKind.H2D)
    want_ops = sum(len(redo_set(sched, i)) for i, c in injected
                   if c == "compute_nan")
    want_k1 = dgemm_ops(sched) + replayed_dgemms(sched, injected)
    require(cap.inj.exhausted() and fs["injected"] == len(injected),
            f"{tag}: {fs['injected']} injected, the plan holds "
            f"{len(injected)}")
    require(fs["replayed_h2d_bytes"] == want_h2d,
            f"{tag}: replayed_h2d_bytes {fs['replayed_h2d_bytes']}, the "
            f"injected H2D ops hold {want_h2d} B")
    require(fs["replayed_ops"] == want_ops,
            f"{tag}: replayed_ops {fs['replayed_ops']}, the redo-sets of "
            f"the injected compute faults hold {want_ops}")
    require((ex.last_h2d_bytes, ex.last_d2h_bytes)
            == (stats["h2d_bytes"], stats["d2h_bytes"]),
            f"{tag}: moved {ex.last_h2d_bytes}/{ex.last_d2h_bytes} B, "
            f"schedule_stats says {stats['h2d_bytes']}/{stats['d2h_bytes']}")
    require(launches == want_k1,
            f"{tag}: {launches} kernel-1 launches, expected {want_k1} "
            f"(dgemm ops + replayed dgemm ops)")
    parity, snaps = ex.last_buffer_bytes, ex.last_snapshot_bytes
    slack = 64 * 2**20
    require(peak <= parity + snaps + extra_bytes + slack,
            f"{tag}: peak device memory {peak} B above parity {parity} B + "
            f"snapshots {snaps} B + workspace {extra_bytes} B + {slack} B")
    wall = ex.last_wall_seconds
    row = {"run": tag, "wall_s": wall, "clean_wall_s": clean_wall,
           "fault_stats": fs, "injected": len(injected),
           "launches": launches, "snapshot_bytes": snaps,
           "parity_bytes": parity, "workspace_bytes": extra_bytes,
           "peak_bytes": peak, "budget_bytes": budget,
           "over_budget_bytes": max(0, peak - budget)}
    report["fault"].append(row)
    say("fault", f"{tag}: {wall:.3f} s wall against {clean_wall:.3f} s "
                 f"clean (same call, same executor; backoff sleep is a "
                 f"no-op); last_fault_stats {json.dumps(fs)}; replayed "
                 f"H2D bytes = the injected H2D ops' ({want_h2d} B), "
                 f"replayed ops = their redo-sets' ({want_ops}), nominal "
                 f"bytes = schedule_stats; kernel 1 {launches} launches = "
                 f"{dgemm_ops(sched)} dgemm ops + "
                 f"{launches - dgemm_ops(sched)} replayed; snapshots "
                 f"{snaps} B; peak {peak} B <= parity {parity} B + "
                 f"snapshots + workspace {extra_bytes} B + 64 MiB, "
                 f"{peak / budget:.3f}x the budget "
                 f"({max(0, peak - budget)} B over)")
    return row


def measured(fn):
    """``fn()`` with kernel 1's launches counted and device memory's peak
    above what was allocated before: (result, launches, peak bytes)."""
    from repro_torch.kernels.block_matmul import block_matmul

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts(block_matmul)
    out = fn()
    torch.cuda.synchronize()
    return out, block_matmul.launches, \
        torch.cuda.max_memory_allocated() - base


def phase_faults(report, A, B, C, host_out, params, factors):
    """Phase 10: ``ooc_gemm`` at 24576^3 f32 under 2 GiB (phase 3's
    operands and result) under ``FaultPlan.random(seed 0, rate 0.1)`` over
    transfer and compute faults, under an empty plan (the armed path, no
    injection) and under an oom at the first compute op (the degrade
    ladder); then ``ooc_cholesky``/``ooc_lu`` at n = 24576 under 1 GiB
    (phase 9's inputs and results) under ``FaultPlan.random(seed 0, rate
    0.02)``, and Cholesky under an oom.  Every result bit for bit equal to
    the clean one; each faulted run's checks in :func:`check_faulted`."""
    from repro_torch.core import (HostOocRuntime, ScheduleExecutor,
                                  build_gemm_schedule,
                                  compile_factor_pipeline, ooc_cholesky,
                                  ooc_gemm, ooc_lu, plan_gemm_partition)
    from repro_torch.core.ooc_factor import (_plan_factor_spec,
                                             panel_workspace_bytes)
    from repro_torch.fault import FaultPolicy
    from repro_torch.kernels.block_matmul import block_matmul

    def policy():
        return FaultPolicy(sleep=lambda s: None)

    alpha, beta, budget = params
    M, K = A.shape
    N = B.shape[1]
    part = plan_gemm_partition(M, N, K, budget, 4)
    ws = part.working_set_bytes(nbuf=2, nstreams=2)
    ex = ScheduleExecutor()
    rt = HostOocRuntime(executor=ex)

    def gemm(**kw):
        return ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget,
                        backend="host", nstreams=2, nbuf=2, runtime=rt, **kw)

    out, launches, peak = measured(gemm)
    require(torch.equal(out, host_out), "fault phase: the clean MMOOC run "
                                        "differs from phase 3's")
    require(peak <= ws + 64 * 2**20,
            f"fault phase: clean MMOOC peak {peak} B above the working set "
            f"{ws} B + 64 MiB")
    clean_wall = ex.last_wall_seconds
    say("fault", f"mmooc {M}x{N}x{K} f32 under {budget} B, clean "
                 f"(issue_order, the path a faulted run takes): "
                 f"{clean_wall:.3f} s wall, "
                 f"{launches} launches, peak {peak} B <= working set {ws} B "
                 f"+ 64 MiB, == phase 3 bitwise")
    for name, cap, key in (
            (f"mmooc FaultPlan.random(seed 0, rate {MMOOC_FAULT_RATE})",
             FaultCapture(0, MMOOC_FAULT_RATE), "fault_host"),
            ("mmooc empty FaultPlan (armed, nothing injected)",
             FaultCapture(0, 0.0), "fault_host_empty")):
        out, launches, peak = measured(lambda: gemm(
            faults=cap, fault_policy=policy()))
        read_counts(block_matmul, report, key)
        require(torch.equal(out, host_out),
                f"{name}: differs from phase 3's result")
        check_faulted(name, ex, cap, launches, peak, 0, budget, clean_wall,
                      report)
        say("fault", f"{name}: == phase 3's result bitwise")
        del out
    pol = policy()
    cap = FaultCapture(oom=True)
    out, launches, peak = measured(lambda: gemm(faults=cap,
                                                fault_policy=pol))
    read_counts(block_matmul, report, "fault_host_oom")
    rungs = [d.action for d in pol.degrades]
    sched1 = build_gemm_schedule(part, nstreams=2, nbuf=1)
    require(rungs == ["halve_nbuf"], f"mmooc oom: ladder {rungs}")
    require(torch.equal(out, host_out), "mmooc oom: the degraded re-run "
                                        "differs from phase 3's result")
    require(launches == dgemm_ops(sched1),
            f"mmooc oom: {launches} launches, the nbuf=1 re-run has "
            f"{dgemm_ops(sched1)} dgemm ops")
    require(peak <= ws + 64 * 2**20,
            f"mmooc oom: peak {peak} B above the nbuf=2 working set {ws} B "
            f"+ 64 MiB (the aborted run's buffers must be freed before the "
            f"re-run)")
    report["fault"].append({"run": "mmooc oom", "rungs": rungs,
                            "wall_s": ex.last_wall_seconds,
                            "launches": launches, "peak_bytes": peak})
    say("fault", f"mmooc oom at the first compute: ladder {rungs}, the "
                 f"nbuf=1 re-run {ex.last_wall_seconds:.3f} s wall, "
                 f"{launches} launches, peak {peak} B (the aborted run's "
                 f"included) <= working set {ws} B + 64 MiB, == phase 3 "
                 f"bitwise")
    del out

    n, pw, fbudget = FACTOR_N, FACTOR_PANEL, FACTOR_BUDGET
    for kind, entry in (("cholesky", ooc_cholesky), ("lu", ooc_lu)):
        Af, first = factors[kind]
        ws_f = panel_workspace_bytes(kind, n, pw, 4, "cuda")
        fex = ScheduleExecutor()

        def factor(**kw):
            res = entry(Af, pw, budget_bytes=fbudget, lookahead=1,
                        nstreams=2, nbuf=2, executor=fex, **kw)
            return res if isinstance(res, tuple) else (res,)

        res, launches, peak = measured(factor)
        require(all(torch.equal(a, b) for a, b in zip(res, first)),
                f"{kind}: the clean run differs from phase 9's")
        require(peak <= fbudget, f"{kind}: clean peak {peak} B above the "
                                 f"budget {fbudget} B")
        clean_wall = fex.last_wall_seconds
        say("fault", f"{kind} n={n} f32 under {fbudget} B, panel {pw}, "
                     f"clean: {clean_wall:.3f} s wall, {launches} launches, "
                     f"peak {peak} B <= budget, == phase 9 bitwise")
        del res
        name = f"{kind} FaultPlan.random(seed 0, rate {FACTOR_FAULT_RATE})"
        cap = FaultCapture(0, FACTOR_FAULT_RATE)
        res, launches, peak = measured(lambda: factor(
            faults=cap, fault_policy=policy()))
        read_counts(block_matmul, report, f"fault_{kind}")
        require(all(torch.equal(a, b) for a, b in zip(res, first)),
                f"{name}: differs from phase 9's result")
        check_faulted(name, fex, cap, launches, peak, ws_f, fbudget,
                      clean_wall, report)
        say("fault", f"{name}: == phase 9's result bitwise")
        del res
        if kind != "cholesky":
            continue
        pol = policy()
        cap = FaultCapture(oom=True)
        res, launches, peak = measured(lambda: factor(faults=cap,
                                                      fault_policy=pol))
        read_counts(block_matmul, report, "fault_cholesky_oom")
        rungs = [(d.action, d.nbuf, d.lookahead, d.budget_bytes)
                 for d in pol.degrades]
        spec1 = _plan_factor_spec(kind, n, pw, pol.degrades[-1].budget_bytes,
                                  4, pol.degrades[-1].lookahead,
                                  pol.degrades[-1].nbuf, "cuda")
        sched1 = compile_factor_pipeline(spec1, nstreams=2,
                                         nbuf=pol.degrades[-1].nbuf)
        require(rungs[0][0] == "halve_nbuf", f"cholesky oom: ladder {rungs}")
        require(all(torch.equal(a, b) for a, b in zip(res, first)),
                "cholesky oom: the degraded re-run differs from phase 9's "
                "result")
        require(launches == dgemm_ops(sched1),
                f"cholesky oom: {launches} launches, the re-run's schedule "
                f"has {dgemm_ops(sched1)} dgemm ops")
        require(peak <= fbudget,
                f"cholesky oom: peak {peak} B above the budget {fbudget} B")
        report["fault"].append({"run": "cholesky oom", "rungs": rungs,
                                "wall_s": fex.last_wall_seconds,
                                "launches": launches, "peak_bytes": peak})
        say("fault", f"cholesky oom at the first compute: rungs (action, "
                     f"nbuf, lookahead, budget) {rungs}; the re-run plans "
                     f"{spec1.bm}x{spec1.bn} trailing blocks, "
                     f"{fex.last_wall_seconds:.3f} s wall, {launches} "
                     f"launches, peak {peak} B <= budget, == phase 9 "
                     f"bitwise (kernel 1 sums K = panel in one order "
                     f"whatever the blocks)")
        del res


# ---------------------------------------------------------------------------
# Phase 11: the autotuner on the card ([tune] lines)
# ---------------------------------------------------------------------------
# the reference's calibration sizes (its defaults, sized for a CPU host):
# 1 MiB and 8 MiB f32 transfers and a 512^3 dgemm
REF_CALIBRATION = dict(small=(256, 1024), large=(2048, 1024), gemm_n=512)
# decode attention at llama3.2-3b's widths over long_500k (phase 6's cell):
# S, Hkv, d, H, budget
TUNE_ATTN = (524288, 8, 128, 24, 512 * 2**20)
# phase 7's bf16 MMOOC budget, and phase 4's SYRK: n, K, budget
TUNE_BF16_BUDGET = 2**30
TUNE_SYRK = (16384, 8192, 2**30)


def profile_text(prof):
    return (f"H2D {prof.h2d_bw / 1e9:.2f} GB/s, D2H {prof.d2h_bw / 1e9:.2f} "
            f"GB/s, {prof.flops / 1e12:.2f} TFLOP/s, per-op overhead "
            f"{prof.per_op_overhead * 1e6:.2f} us")


def tune_calibrate(gen, report, card):
    """Calibrate the card at its defaults and at the reference's sizes,
    print both profiles beside kernel 1's measured f32 and bf16 rates at
    the cells' block, and the fingerprint twice (they must be equal).
    Returns the card-default calibration."""
    from repro_torch.kernels.block_matmul import block_matmul
    from repro_torch.tune import calibrate, hardware_fingerprint

    zero_counts(block_matmul)
    t0 = time.perf_counter()
    res = calibrate(torch_device="cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = calibrate(torch_device="cuda", **REF_CALIBRATION)
    t_ref = time.perf_counter() - t0
    read_counts(block_matmul, report, "tune_calibrate")
    fp = hardware_fingerprint()
    require(res.fingerprint == ref.fingerprint == fp,
            f"fingerprints differ: {res.fingerprint}, {ref.fingerprint}, "
            f"{fp}")
    for prof in (res.profile, ref.profile):
        require(all(math.isfinite(r) and r > 0 for r in (
            prof.h2d_bw, prof.d2h_bw, prof.flops)),
            f"calibrated rates not finite and positive: {prof}")
    M, N, K = TIMING_SHAPE
    rates = {}
    saved = block_matmul.launches
    for dt in (torch.float32, torch.bfloat16):
        a, b, c = (rand(s, gen, dt) for s in ((M, K), (K, N), (M, N)))
        ms = time_ms(lambda: block_matmul(a, b, c, alpha=1.0, beta=0.0,
                                          out=c), reps=3)
        rates[str(dt)[6:]] = 2 * M * N * K / ms / 1e9
        del a, b, c
    block_matmul.launches = saved      # timing launches are not the path's
    report["tune_calibration"] = {
        "card_defaults": {**dataclasses.asdict(res.profile),
                          "samples": res.samples, "seconds": t_card},
        "reference_sizes": {**dataclasses.asdict(ref.profile),
                            "samples": ref.samples, "seconds": t_ref},
        "kernel1_tflops": rates, "fingerprint": fp, "card": card}
    say("tune", f"calibrate() at the card defaults (8 MiB and 128 MiB f32 "
                f"transfers, a 4096^3 dgemm on kernel 1), {t_card:.1f} s: "
                f"{profile_text(res.profile)}; samples "
                f"{json.dumps(res.samples)}")
    say("tune", f"calibrate() at the reference's sizes (1 MiB and 8 MiB, a "
                f"512^3 dgemm), {t_ref:.1f} s: {profile_text(ref.profile)}; "
                f"samples {json.dumps(ref.samples)}")
    say("tune", f"kernel 1 at the cells' block {M}x{N}x{K}: "
                f"{rates['float32']:.2f} TFLOP/s f32, "
                f"{rates['bfloat16']:.2f} TFLOP/s bf16 "
                f"({rates['bfloat16'] / rates['float32']:.1f}x f32); the "
                f"profile holds one rate, the f32 dgemm's, so bf16 plans are "
                f"ranked as if kernel 1 ran at it; fingerprint {fp} (card "
                f"defaults) == {res.fingerprint} == {ref.fingerprint}; card "
                f"{card}")
    return res


def timed_search(tuner, fn):
    """(plan, seconds) of one plan request that must search."""
    before = tuner.searches
    t0 = time.perf_counter()
    plan = fn()
    seconds = time.perf_counter() - t0
    require(tuner.searches == before + 1 and not tuner.last_from_cache,
            "the first request for a key did not search")
    return plan, seconds


def plan_text(plan):
    p = dict(plan.params)
    if "bs" in p:
        blocks = f"{p['nblocks']} KV blocks of {p['bs']}"
    elif "panel" in p:
        blocks = (f"panel {p['panel']}, lookahead {p['lookahead']}, "
                  f"trailing blocks {p['bm']}x{p['bn']}")
    else:
        blocks = f"{p['h']}x{p['w']} blocks of {p['bm']}x{p['bn']}"
    return (f"{blocks}, nstreams {plan.nstreams}, nbuf {plan.nbuf}, "
            f"traversal {plan.traversal}, eviction {plan.evict}")


def last_drift():
    from repro_torch.obs import get_observability

    return get_observability().drift.snapshot()["records"][-1]


def tuned_pair(tag, run, key, report, tuner, expect):
    """The untuned call (cold, warm) and the tuned call (cold from the
    cache, warm), each on its own executor.  ``run(tuned, ex)`` makes one
    call and returns its result as a tuple; ``expect`` holds the tuned
    schedule's stats and compute ops, the plan, the budget, the
    reference result (or None: the untuned cold result) and the result
    check.  Kernel 1's launches on the tuned cold run are kept under
    ``key``; checks raise."""
    from repro_torch.core import ScheduleExecutor

    plan, stats, n_ops, budget, count = (
        expect["plan"], expect["stats"], expect["ops"], expect["budget"],
        expect["count"])
    rows = {}
    for tuned in (False, True):
        ex = ScheduleExecutor()
        for rep in ("cold", "warm"):
            ex.record_spans = rep == "warm"
            searches = tuner.searches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            count.zero()
            res = run(tuned, ex)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            launches = count.read()
            wall = ex.last_wall_seconds
            row = {"run": tag, "tuned": tuned, "rep": rep, "wall_s": wall,
                   "peak_bytes": peak, "budget_bytes": budget,
                   "launches": launches, "parity_bytes": ex.last_buffer_bytes,
                   "h2d_bytes": ex.last_h2d_bytes,
                   "d2h_bytes": ex.last_d2h_bytes,
                   "stage_s": ex.last_stage_seconds}
            if ex.last_spans:
                covered, reach = 0.0, 0.0   # union of the op spans
                for _, _, a, b in sorted(ex.last_spans, key=lambda s: s[2]):
                    covered += max(0.0, b - max(a, reach))
                    reach = max(reach, b)
                row["device_idle_share"] = 1.0 - covered / wall
            if tuned:
                require(tuner.searches == searches and tuner.last_from_cache,
                        f"{tag}: the tuned call searched again")
                require(launches == n_ops,
                        f"{tag}: {launches} launches, the tuned schedule has "
                        f"{n_ops} compute ops")
                require((ex.last_h2d_bytes, ex.last_d2h_bytes)
                        == (stats["h2d_bytes"], stats["d2h_bytes"]),
                        f"{tag}: moved {ex.last_h2d_bytes}/"
                        f"{ex.last_d2h_bytes} B, the tuned schedule's "
                        f"schedule_stats says {stats['h2d_bytes']}/"
                        f"{stats['d2h_bytes']}")
                drift = last_drift()
                require(drift["byte_ratio"] == 1.0,
                        f"{tag}: drift byte ratio {drift['byte_ratio']}")
                row["predicted_s"] = plan.makespan
                row["measured_over_predicted"] = wall / plan.makespan
                row["drift_time_ratio"] = drift["time_ratio"]
                if rep == "cold":
                    count.keep(report, key)
                    expect["check"](res, rows["untuned cold"]["result"])
            rows[f"{'tuned' if tuned else 'untuned'} {rep}"] = {
                **row, "result": res if rep == "cold" else None}
            del res
    untuned, tuned = rows["untuned cold"], rows["tuned cold"]
    if untuned["peak_bytes"] <= budget:
        require(tuned["peak_bytes"] <= budget,
                f"{tag}: tuned peak {tuned['peak_bytes']} B above the "
                f"budget {budget} B, where the untuned run's "
                f"{untuned['peak_bytes']} B is within it")
    slack = 64 * 2**20
    require(tuned["peak_bytes"] <= tuned["parity_bytes"]
            + expect.get("workspace", 0) + slack,
            f"{tag}: tuned peak {tuned['peak_bytes']} B above parity "
            f"{tuned['parity_bytes']} B + workspace + {slack} B")
    for r in rows.values():
        r.pop("result")
        report["tune"].append(r)
    tw, uw = rows["tuned warm"], rows["untuned warm"]
    say("tune", f"{tag}: tuned plan {plan_text(plan)}; warm wall tuned "
                f"{tw['wall_s']:.3f} s against untuned {uw['wall_s']:.3f} s "
                f"(same call; device idle {100 * tw['device_idle_share']:.1f}"
                f" / {100 * uw['device_idle_share']:.1f} % of the wall); "
                f"predicted makespan {plan.makespan:.4f} s (untuned plan "
                f"{plan.baseline_makespan:.4f} s), measured/predicted "
                f"{tw['measured_over_predicted']:.2f} (drift record "
                f"{tw['drift_time_ratio']:.2f}; host staging fill "
                f"{tw['stage_s']:.3f} s is not in the model); bytes "
                f"{tw['h2d_bytes']}/{tw['d2h_bytes']} = the tuned schedule's "
                f"schedule_stats; {tuned['launches']} launches = its "
                f"{n_ops} compute ops (untuned {untuned['launches']}); peak "
                f"{tuned['peak_bytes'] / budget:.3f}x the budget (untuned "
                f"{untuned['peak_bytes'] / budget:.3f}x); the repeat calls "
                f"came from the cache ({tuner.searches} searches so far)")
    return rows


class Counter1:
    """Kernel 1's launches as ``tuned_pair`` zeroes, reads and keeps
    them."""

    def zero(self):
        from repro_torch.kernels.block_matmul import block_matmul
        zero_counts(block_matmul)

    def read(self):
        from repro_torch.kernels.block_matmul import block_matmul
        return block_matmul.launches

    def keep(self, report, key):
        from repro_torch.kernels.block_matmul import block_matmul
        read_counts(block_matmul, report, key)


class CounterAttn:
    """Kernel 2's launches (both passes), the same way."""

    def zero(self):
        from repro_torch.kernels import flash_attention as kfa
        kfa.flash_partial.launches = kfa.flash_combine.launches = 0

    def read(self):
        from repro_torch.kernels import flash_attention as kfa
        return kfa.flash_partial.launches + kfa.flash_combine.launches

    def keep(self, report, key):
        from repro_torch.kernels import flash_attention as kfa
        report["launches"][key] = {"partial": kfa.flash_partial.launches,
                                   "combine": kfa.flash_combine.launches}


def phase_tune(gen, report, card, A, B, C, host_out, params, factors):
    """Phase 11: ``calibrate()`` on the card, then ``tune="auto"`` through
    every entry point that the reference tunes, with an ``AutoTuner`` on
    the measured profile and a temporary plan cache: each key searched
    once (its seconds printed) and every later call served from the
    cache.  Each tuned call beside the untuned one in the same call;
    tuned MMOOC and SYRK bit for bit equal to untuned, a factorization at
    the requested panel width bit for bit equal to phase 9's (else held
    to its float64 oracle), attention to phase 6's tolerance; bytes equal
    to the tuned schedule's ``schedule_stats``; launches equal to its
    compute ops; peak memory within the budget wherever the untuned
    run's is.  Then the tuned oom ladder: one ``halve_budget`` rung, its
    re-run bit for bit equal to a tuned run at half the budget.  Returns
    the calibrated profile and the tuned MMOOC f32 and SYRK plans."""
    from repro_torch.core import (HostOocRuntime, ScheduleExecutor,
                                  build_attention_schedule,
                                  build_gemm_schedule, build_syrk_schedule,
                                  compile_factor_pipeline, ooc_attention,
                                  ooc_cholesky, ooc_gemm, ooc_lu, ooc_syrk,
                                  schedule_stats)
    from repro_torch.core.ooc_factor import (_tuned_factor_spec,
                                             panel_workspace_bytes)
    from repro_torch.fault import FaultPolicy
    from repro_torch.kernels.block_matmul import block_matmul
    from repro_torch.obs import get_observability
    from repro_torch.tune import AutoTuner, PlanCache

    cal = tune_calibrate(gen, report, card)
    obs = get_observability()
    obs.enable(metrics=True)           # the drift records of tuned runs
    tmp = tempfile.TemporaryDirectory()
    tuner = AutoTuner(profile=cal.profile, fingerprint=cal.fingerprint,
                      cache=PlanCache(os.path.join(tmp.name, "plans.json")))
    report["tune_searches"] = searches = {}
    tuned = {}
    k1 = Counter1()

    def gemm_expect(plan, kernel, budget, check):
        build = build_gemm_schedule if kernel == "gemm" \
            else build_syrk_schedule
        sched = build(plan.gemm_partition(), nstreams=plan.nstreams,
                      nbuf=plan.nbuf, traversal=plan.traversal,
                      evict=plan.evict)
        return {"plan": plan, "stats": schedule_stats(sched),
                "ops": dgemm_ops(sched), "budget": budget, "check": check,
                "count": k1}

    def bitwise(tag):
        def check(res, ref):
            require(all(torch.equal(a, b) for a, b in zip(res, ref)),
                    f"{tag}: the tuned result differs from the untuned one")
            say("tune", f"{tag}: tuned == untuned, bitwise")
        return check

    try:
        # MMOOC f32 (phase 3's operands; its result is the untuned one)
        alpha, beta, budget = params
        M, K = A.shape
        N = B.shape[1]
        plan, secs = timed_search(tuner, lambda: tuner.gemm_plan(
            M, N, K, budget, "float32"))
        searches["gemm f32"] = secs
        tuned["gemm f32"] = plan
        say("tune", f"search gemm {M}x{N}x{K} f32 under {budget} B: "
                    f"{secs:.1f} s, {plan_text(plan)}")

        def mmooc(tuned, ex, A=A, B=B, C=C, budget=budget):
            return (ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget,
                             tune="auto" if tuned else None, tuner=tuner,
                             runtime=HostOocRuntime(executor=ex)),)

        def f32_check(res, ref):
            bitwise("mmooc f32")(res, ref)
            require(torch.equal(res[0], host_out),
                    "mmooc f32: the tuned result differs from phase 3's")

        tuned_pair("mmooc f32", mmooc, "tune_gemm", report, tuner,
                   gemm_expect(plan, "gemm", budget, f32_check))
        # MMOOC bf16 (the phase 7 cell, operands made again from the seed)
        t0 = time.perf_counter()
        Ah, Bh, Ch = (rand(s, gen, torch.bfloat16, device="cpu")
                      for s in ((M, K), (K, N), (M, N)))
        bbudget = TUNE_BF16_BUDGET
        plan, secs = timed_search(tuner, lambda: tuner.gemm_plan(
            M, N, K, bbudget, "bfloat16"))
        searches["gemm bf16"] = secs
        say("tune", f"search gemm {M}x{N}x{K} bf16 under {bbudget} B: "
                    f"{secs:.1f} s, {plan_text(plan)} (operands made in "
                    f"{time.perf_counter() - t0 - secs:.1f} s)")
        tuned_pair("mmooc bf16", lambda tuned, ex: mmooc(
            tuned, ex, Ah, Bh, Ch, bbudget), "tune_gemm_bf16", report, tuner,
            gemm_expect(plan, "gemm", bbudget, bitwise("mmooc bf16")))
        del Ah, Bh, Ch
        # SYRK at phase 4's shape
        n, Ks, sbudget = TUNE_SYRK
        P = rand((n, Ks), gen, device="cpu")
        Cs = rand((n, n), gen, device="cpu")
        plan, secs = timed_search(tuner, lambda: tuner.syrk_plan(
            n, Ks, sbudget, "float32"))
        searches["syrk f32"] = secs
        tuned["syrk f32"] = plan
        say("tune", f"search syrk n={n} K={Ks} f32 under {sbudget} B: "
                    f"{secs:.1f} s, {plan_text(plan)}")
        tuned_pair("syrk f32", lambda tuned, ex: (ooc_syrk(
            P, Cs, -1.0, 0.5, budget_bytes=sbudget,
            tune="auto" if tuned else None, tuner=tuner,
            runtime=HostOocRuntime(executor=ex)),), "tune_syrk", report,
            tuner, gemm_expect(plan, "syrk", sbudget, bitwise("syrk f32")))
        del P, Cs
        # the factorizations (phase 9's inputs and results)
        nf, pw, fbudget = FACTOR_N, FACTOR_PANEL, FACTOR_BUDGET
        for kind, entry in (("cholesky", ooc_cholesky), ("lu", ooc_lu)):
            Af, first = factors[kind]
            ws = panel_workspace_bytes(kind, nf, pw, 4, "cuda")
            plan, secs = timed_search(tuner, lambda: tuner.factor_plan(
                kind, nf, pw, fbudget - ws, "float32"))
            searches[kind] = secs
            spec, ns, nb, ev, cached = _tuned_factor_spec(
                tuner, kind, nf, pw, fbudget, 4, torch.float32, "cuda")
            require(cached == plan, f"{kind}: the entry point's plan is not "
                                    f"the searched one")
            sched = compile_factor_pipeline(spec, nstreams=ns, nbuf=nb,
                                            evict=ev)
            say("tune", f"search {kind} n={nf} panel {pw} f32 under "
                        f"{fbudget} B less {ws} B of panel-op workspace "
                        f"({fbudget - ws} B, the key's budget): {secs:.1f} "
                        f"s, {plan_text(plan)}")

            def check(res, ref, kind=kind, Af=Af, first=first, plan=plan):
                if plan.param("panel") == pw:
                    require(all(torch.equal(a, b)
                                for a, b in zip(res, first)),
                            f"{kind}: tuned at panel {pw} differs from "
                            f"phase 9's result")
                    say("tune", f"{kind}: tuned keeps panel {pw}: == phase "
                                f"9's result, bitwise")
                else:
                    factor_oracle(kind, Af, res, nf)
                    say("tune", f"{kind}: tuned panel {plan.param('panel')}"
                                f" != {pw}: held to phase 9's float64 "
                                f"oracle")

            def factor(tuned, ex, entry=entry, Af=Af):
                res = entry(Af, pw, budget_bytes=fbudget,
                            tune="auto" if tuned else None, tuner=tuner,
                            lookahead=1, nstreams=2, nbuf=2, executor=ex)
                return res if isinstance(res, tuple) else (res,)

            rows = tuned_pair(
                kind, factor, f"tune_{kind}", report, tuner,
                {"plan": plan, "stats": schedule_stats(sched),
                 "ops": dgemm_ops(sched), "budget": fbudget, "check": check,
                 "count": k1, "workspace": ws})
            for r in ("untuned cold", "tuned cold"):
                require(rows[r]["peak_bytes"] <= fbudget,
                        f"{kind} {r}: peak {rows[r]['peak_bytes']} B above "
                        f"the budget {fbudget} B")
        # decode attention at phase 6's cell
        S, hkv, d, H, abudget = TUNE_ATTN
        K_ = rand((S, hkv, d), gen, torch.bfloat16, device="cpu")
        V_ = rand((S, hkv, d), gen, torch.bfloat16, device="cpu")
        q = rand((H, d), gen, device="cpu")
        plan, secs = timed_search(tuner, lambda: tuner.attention_plan(
            S, hkv, d, H, abudget, "bfloat16"))
        searches["attention bf16"] = secs
        say("tune", f"search attention S={S} Hkv={hkv} d={d} H={H} bf16 "
                    f"under {abudget} B: {secs:.2f} s, {plan_text(plan)}")
        asched = build_attention_schedule(plan.attention_partition(), hkv,
                                          d, H, nstreams=plan.nstreams,
                                          nbuf=plan.nbuf)

        def attn_check(res, ref):
            exact = attn_oracle(q, K_.cuda(), V_.cuda())
            err = (res[0].cuda().double() - exact).abs().max().item()
            require(err <= 2e-4, f"tuned attention: max err {err} vs "
                                 f"float64 beyond 2e-4")
            same = all(torch.equal(a, b) for a, b in zip(res, ref))
            say("tune", f"attention: tuned vs float64 on the card max abs "
                        f"err {err:.3g} (phase 6's limit 2e-4); equal to "
                        f"the untuned result bit for bit: {same}")

        def attn(tuned, ex):
            return (ooc_attention(q, K_, V_, budget_bytes=abudget,
                                  tune="auto" if tuned else None,
                                  tuner=tuner, executor=ex),)

        tuned_pair("attention bf16", attn, "tune_attention", report, tuner,
                   {"plan": plan, "stats": schedule_stats(asched),
                    "ops": 2 * plan.param("nblocks") + 1, "budget": abudget,
                    "check": attn_check, "count": CounterAttn()})
        del K_, V_, q
        # the tuned oom ladder on the MMOOC f32 cell
        pol = FaultPolicy(sleep=lambda s: None)
        cap = FaultCapture(oom=True)
        ex = ScheduleExecutor()
        before = tuner.searches
        t0 = time.perf_counter()
        out, launches, peak = measured(lambda: ooc_gemm(
            A, B, C, alpha, beta, budget_bytes=budget, tune="auto",
            tuner=tuner, runtime=HostOocRuntime(executor=ex), faults=cap,
            fault_policy=pol))
        call_s = time.perf_counter() - t0
        read_counts(block_matmul, report, "tune_oom")
        rerun_s = ex.last_wall_seconds
        rungs = [(s.action, s.budget_bytes) for s in pol.degrades]
        require(rungs == [("halve_budget", budget // 2)],
                f"tuned mmooc oom: ladder {rungs}")
        require(tuner.searches == before + 1,
                "tuned mmooc oom: the rung did not search its budget")
        half = tuner.gemm_plan(M, N, K, budget // 2, "float32")
        require(tuner.last_from_cache, "the half-budget plan is not cached")
        hsched = build_gemm_schedule(half.gemm_partition(),
                                     nstreams=half.nstreams, nbuf=half.nbuf,
                                     traversal=half.traversal,
                                     evict=half.evict)
        require(launches == dgemm_ops(hsched),
                f"tuned mmooc oom: {launches} launches, the half-budget "
                f"plan has {dgemm_ops(hsched)} dgemm ops")
        direct = ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget // 2,
                          tune="auto", tuner=tuner)
        require(torch.equal(out, direct),
                "tuned mmooc oom: the re-run differs from a tuned run at "
                "half the budget")
        require(torch.equal(out, host_out),
                "tuned mmooc oom: the re-run differs from phase 3's result")
        searches["gemm f32 half budget (in the ladder)"] = call_s - rerun_s
        report["tune"].append({"run": "mmooc oom tuned", "rungs": rungs,
                               "call_s": call_s, "rerun_wall_s": rerun_s,
                               "launches": launches, "peak_bytes": peak,
                               "budget_bytes": budget})
        say("tune", f"tuned mmooc oom at the first compute: ladder {rungs} "
                    f"(budget halvings only); the rung searched "
                    f"{budget // 2} B ({call_s - rerun_s:.1f} s of the "
                    f"{call_s:.1f} s call) and re-ran {plan_text(half)} in "
                    f"{rerun_s:.3f} s, {launches} launches, peak {peak} B "
                    f"({peak / budget:.3f}x the budget); == a tuned run at "
                    f"half the budget, bitwise, and == phase 3's result")
        del out, direct
        say("tune", f"searches (s): {json.dumps(searches)}; plan cache "
                    f"{tuner.cache.hits} hits, {tuner.cache.misses} misses, "
                    f"{len(tuner.cache)} plans")
    finally:
        obs.reset().disable()
        tmp.cleanup()
    return cal.profile, tuned


# ---------------------------------------------------------------------------
# Phase 12: hybrid co-execution on one card ([hybrid] lines)
# ---------------------------------------------------------------------------
# the reference's hybrid tests' and example's search knobs
HYBRID_OPTS = dict(nbuf_options=(1, 2), max_steps=256)
# the hybrid Cholesky: n, panel, each member's budget
HYBRID_CHOL = (8192, 2048, 128 * 2**20)


def hybrid_pair(budget):
    """The reference's member pair, both on this card: the canned GPU and
    Xeon Phi profiles (fixed inputs, so the split does not move between
    calls), each with ``budget`` bytes."""
    from repro_torch.hybrid import DeviceSpec
    from repro_torch.tune import gpu_profile, phi_profile

    return [DeviceSpec("gpu0", gpu_profile(), budget),
            DeviceSpec("phi0", phi_profile(), budget)]


def parity_bytes(sched):
    """Device bytes the executor allocates for ``sched``: one buffer per
    H2D-landed parity key, sized for its largest block."""
    from repro_torch.core import OpKind

    need = {}
    for op in sched.ops:
        if op.kind == OpKind.H2D:
            key = op.buffers_written[0]
            need[key] = max(need.get(key, 0), op.bytes)
    return sum(need.values())


def compute_ops(sched, kernel):
    from repro_torch.core import BlockRef, OpKind

    return sum(1 for op in sched.ops if op.kind == OpKind.COMPUTE
               and isinstance(op.payload, BlockRef)
               and op.payload.kernel == kernel)


def hybrid_plan(tag, fn):
    """Plan with ``fn()`` and print the split: each member's rows or
    positions, block shape, streams, buffers, predicted seconds (canned
    profiles), and the plan's seconds on this host."""
    t0 = time.perf_counter()
    hp = fn()
    secs = time.perf_counter() - t0
    members = "; ".join(
        f"{dp.device.name} [{dp.start}, {dp.start + dp.length}) "
        f"{dict(dp.plan.params)} s{dp.plan.nstreams}b{dp.plan.nbuf} "
        f"{dp.plan.traversal}/{dp.plan.evict} predicted "
        f"{dp.plan.makespan:.3f} s" for dp in hp.device_plans)
    say("hybrid", f"{tag}: planned in {secs:.2f} s on the host "
                  f"({hp.balance.iterations} balance iterations, spread "
                  f"{hp.balance.spread:.4f}): {members}")
    return hp, secs


def hybrid_expect(hp):
    """What the members' schedules say: compute ops by kernel, summed
    ``schedule_stats`` bytes, summed parity bytes."""
    from repro_torch.core import schedule_stats
    from repro_torch.hybrid import device_schedule

    out = {"dgemm": 0, "attn": 0, "h2d": 0, "d2h": 0, "parity": 0,
           "by_member": {}}
    for dp in hp.device_plans:
        s = device_schedule(hp, dp)
        st = schedule_stats(s)
        row = {"dgemm": compute_ops(s, "dgemm"),
               "attn": compute_ops(s, "attn"), "h2d": st["h2d_bytes"],
               "d2h": st["d2h_bytes"], "parity": parity_bytes(s)}
        out["by_member"][dp.device.name] = row
        for k in ("dgemm", "attn", "h2d", "d2h", "parity"):
            out[k] += row[k]
    return out


def member_busy(spans, wall):
    """A member's device busy time (union of its op spans) and idle share
    of its wall."""
    covered, reach = 0.0, 0.0
    for _, _, a, b in sorted(spans, key=lambda s: s[2]):
        covered += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return covered, 1.0 - covered / wall if wall else 0.0


def hybrid_call(tag, fn, report, key, counter, extra=0):
    """``fn()`` once, measured: launches (``counter``), cudaMalloc calls,
    peak device memory above what was allocated before, the call's wall,
    and the run's stats (``last_run_stats``).  Launches are kept under
    ``key``."""
    from repro_torch.hybrid.executor import last_run_stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mallocs = torch.cuda.memory_stats()["num_device_alloc"]
    counter.zero()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
    launches = counter.read()
    if key is not None:
        counter.keep(report, key)
    return res, {"tag": tag, "call_s": wall, "peak_bytes": peak,
                 "cuda_mallocs": mallocs, "launches": launches,
                 "stats": last_run_stats()}


def hybrid_row(m, exp, budget_sum, report, spans=None):
    """Check and print one clean hybrid call: summed bytes equal the
    schedules' (measured and modeled), peak within the summed parity
    buffers (+ ``exp["scratch"]``) and 64 MiB slack."""
    st = m["stats"]
    slack = 64 * 2**20
    require(st["h2d_bytes"] == st["sched_h2d_bytes"] == exp["h2d"]
            and st["d2h_bytes"] == st["sched_d2h_bytes"] == exp["d2h"],
            f"{m['tag']}: moved {st['h2d_bytes']}/{st['d2h_bytes']} B, the "
            f"members' schedule_stats say {exp['h2d']}/{exp['d2h']}")
    bound = exp["parity"] + exp.get("scratch", 0)
    require(m["peak_bytes"] <= bound + slack,
            f"{m['tag']}: peak {m['peak_bytes']} B above the members' "
            f"parity buffers {bound} B + 64 MiB")
    walls = st["device_walls"]
    stage = st["device_stage_seconds"]
    row = {"path": m["tag"], "call_s": m["call_s"],
           "member_walls_s": walls, "member_stage_s": stage,
           "lag_s": st["lag_seconds"],
           "launches": m["launches"], "peak_bytes": m["peak_bytes"],
           "cuda_mallocs": m["cuda_mallocs"], "h2d_bytes": st["h2d_bytes"],
           "d2h_bytes": st["d2h_bytes"], "parity_bytes": exp["parity"],
           "budget_bytes": budget_sum}
    busy = ""
    if spans:
        row["member_busy_s"], row["member_idle_share"] = {}, {}
        for name, sp in spans:
            b, idle = member_busy(sp, walls[name])
            row["member_busy_s"][name] = b
            row["member_idle_share"][name] = idle
        busy = "; device busy " + ", ".join(
            f"{n} {row['member_busy_s'][n]:.3f} s (idle "
            f"{100 * row['member_idle_share'][n]:.1f} % of its wall)"
            for n in row["member_busy_s"])
    report["hybrid"].append(row)
    say("hybrid", f"{m['tag']}: {m['call_s']:.3f} s call, member walls "
                  + ", ".join(f"{n} {w:.3f} s" for n, w in walls.items())
                  + f" (lag {st['lag_seconds']:.3f} s), host staging fill "
                  + ", ".join(f"{n} {v:.3f} s" for n, v in stage.items())
                  + f"; {m['launches']} "
                  f"launches; bytes {st['h2d_bytes']}/{st['d2h_bytes']} = "
                  f"the members' schedule_stats; peak {m['peak_bytes']} B "
                  f"<= parity {bound} B + 64 MiB ("
                  f"{m['peak_bytes'] / budget_sum:.3f}x the summed budgets"
                  f"); {m['cuda_mallocs']} cudaMalloc" + busy)
    return row


def first_compute_lost(sched):
    from repro_torch.core import OpKind
    from repro_torch.fault import FaultPlan, FaultSpec

    i = next(i for i, op in enumerate(sched.ops)
             if op.kind == OpKind.COMPUTE)
    return FaultPlan(specs=(FaultSpec(op=i, cls="device_lost"),))


def hybrid_gemm_case(report, A, B, C, host_out, params):
    """MMOOC 24576^3 f32 across the pair (1 GiB each, phase 3's 2 GiB in
    all), cold and warm, then with gpu0 and then phi0 lost at its first
    compute.  Returns the plan."""
    from repro_torch.fault import FaultPolicy
    from repro_torch.hybrid import (device_schedule, plan_hybrid_gemm,
                                    run_hybrid_gemm)

    alpha, beta, budget = params
    M, K = A.shape
    N = B.shape[1]
    mb = budget // 2
    hp, secs = hybrid_plan(f"mmooc {M}x{N}x{K} f32, {mb} B each",
                           lambda: plan_hybrid_gemm(
                               M, N, K, hybrid_pair(mb), **HYBRID_OPTS))
    exp = hybrid_expect(hp)
    report["hybrid_plans"]["mmooc"] = secs
    require(len(hp.device_plans) == 2, "mmooc: a member took no rows")
    clean = None
    for rep in ("cold", "warm"):
        (out, groups), m = hybrid_call(
            f"mmooc {rep}",
            lambda: run_hybrid_gemm(A, B, C, alpha, beta, hp,
                                    record_spans=rep == "warm"),
            report, "hybrid_gemm" if rep == "cold" else None, Counter1())
        require(m["launches"] == exp["dgemm"],
                f"mmooc {rep}: {m['launches']} launches, the members' "
                f"schedules have {exp['dgemm']} dgemm ops")
        require(torch.equal(out, host_out),
                f"mmooc {rep}: differs from phase 3's result")
        row = hybrid_row(m, exp, budget, report,
                         groups if rep == "warm" else None)
        row["predicted_s"] = hp.predicted_makespan
        ratio = m["stats"]["wall_seconds"] / hp.predicted_makespan
        say("hybrid", f"mmooc {rep}: == phase 3's single-device result bit "
                      f"for bit; predicted makespan (canned profiles) "
                      f"{hp.predicted_makespan:.3f} s, measured/predicted "
                      f"{ratio:.3f}")
        clean = out
    del out
    pol = FaultPolicy(sleep=lambda s: None)
    for i, dead in enumerate(("gpu0", "phi0")):
        (out, groups), m = hybrid_call(
            f"mmooc {dead} lost",
            lambda: run_hybrid_gemm(A, B, C, alpha, beta, hp,
                                    fault_plans={dead: first_compute_lost},
                                    fault_policy=pol),
            report, f"hybrid_gemm_lost_{dead}", Counter1())
        st = m["stats"]
        require(st["lost"] == [dead], f"{dead} lost: lost {st['lost']}")
        (reb,) = st["rebalanced"]
        sub = reb["plan"]
        sub_ops = sum(compute_ops(device_schedule(sub, dp), "dgemm")
                      for dp in sub.device_plans)
        live = sum(r["dgemm"] for n, r in exp["by_member"].items()
                   if n != dead)
        require(m["launches"] == live + sub_ops,
                f"{dead} lost: {m['launches']} launches, expected {live} "
                f"(survivors) + {sub_ops} (rebalanced band)")
        live_h2d = sum(r["h2d"] for n, r in exp["by_member"].items()
                       if n != dead)
        require(st["h2d_bytes"] == st["sched_h2d_bytes"] == live_h2d
                and reb["h2d_bytes"] == reb["sched_h2d_bytes"],
                f"{dead} lost: bytes {st['h2d_bytes']} / rebalance "
                f"{reb['h2d_bytes']} differ from the schedules'")
        names = [g for g, _ in groups]
        require(any(f"(rebalance {dead})" in g for g in names)
                and dead not in names,
                f"{dead} lost: lane groups {names}")
        require(torch.equal(out, clean),
                f"{dead} lost: differs from the clean hybrid run")
        row = {"path": m["tag"], "call_s": m["call_s"],
               "launches": m["launches"], "peak_bytes": m["peak_bytes"],
               "survivor_wall_s": st["wall_seconds"],
               "rebalance_wall_s": reb["wall_seconds"],
               "rebalance_members": [(dp.device.name, dp.length)
                                     for dp in sub.device_plans],
               "lane_groups": names}
        report["hybrid"].append(row)
        say("hybrid", f"mmooc {dead} lost at its first compute: "
                      f"{m['call_s']:.3f} s call (survivor "
                      f"{st['wall_seconds']:.3f} s, band of "
                      f"{sum(dp.length for dp in sub.device_plans)} rows "
                      f"rebalanced, planned with the default search and run "
                      f"in {reb['wall_seconds']:.3f} s); {m['launches']} = "
                      f"{live} + {sub_ops} launches; bytes = the schedules'; "
                      f"lane groups {names}; == the clean hybrid run bit "
                      f"for bit")
        del out
    del clean
    return hp


def hybrid_syrk_case(report, syrk):
    """``ooc_syrk`` n = 16384, K = 8192 across the pair (512 MiB each,
    phase 4's 1 GiB in all), cold and warm."""
    from repro_torch.hybrid import plan_hybrid_syrk, run_hybrid_syrk

    P, Cs, ref = syrk
    n, K = P.shape
    mb = 2**29
    hp, secs = hybrid_plan(f"syrk n={n} K={K} f32, {mb} B each",
                           lambda: plan_hybrid_syrk(n, K, hybrid_pair(mb),
                                                    **HYBRID_OPTS))
    report["hybrid_plans"]["syrk"] = secs
    exp = hybrid_expect(hp)
    for rep in ("cold", "warm"):
        (out, groups), m = hybrid_call(
            f"syrk {rep}",
            lambda: run_hybrid_syrk(P, Cs, -1.0, 0.5, hp,
                                    record_spans=rep == "warm"),
            report, "hybrid_syrk" if rep == "cold" else None, Counter1())
        require(m["launches"] == exp["dgemm"],
                f"syrk {rep}: {m['launches']} launches, expected "
                f"{exp['dgemm']}")
        require(torch.equal(out, ref),
                f"syrk {rep}: differs from phase 4's result")
        hybrid_row(m, exp, 2 * mb, report,
                   groups if rep == "warm" else None)
        say("hybrid", f"syrk {rep}: == phase 4's single-device result bit "
                      f"for bit")


def hybrid_attention_case(report, attn):
    """``ooc_attention`` at phase 6's cell across the pair (256 MiB each,
    phase 6's 512 MiB in all), cold and warm."""
    from repro_torch.core import ooc_attention
    from repro_torch.hybrid import plan_hybrid_attention, run_hybrid_attention
    from repro_torch.kernels import flash_attention as kfa

    q, Kc, Vc, single = attn
    S, hkv, d = Kc.shape
    H = q.shape[0]
    mb = 2**28
    hp, secs = hybrid_plan(
        f"attention S={S} Hkv={hkv} d={d} H={H} bf16, {mb} B each",
        lambda: plan_hybrid_attention(S, hkv, d, H, hybrid_pair(mb),
                                      dtype=Kc.dtype))
    report["hybrid_plans"]["attention"] = secs
    exp = hybrid_expect(hp)
    nsplit = max(kfa.nsplits(dp.plan.param("bs"), 512)
                 for dp in hp.device_plans)
    exp["scratch"] = len(hp.device_plans) * (
        2 * H + 3 * H * d + nsplit * H * (d + 2)) * 4
    exact = attn_oracle(q, Kc.cuda(), Vc.cuda())
    for rep in ("cold", "warm"):
        (out, groups), m = hybrid_call(
            f"attention {rep}",
            lambda: run_hybrid_attention(q, Kc, Vc, hp,
                                         record_spans=rep == "warm"),
            report, "hybrid_attention" if rep == "cold" else None,
            CounterAttn())
        require(m["launches"] == 2 * exp["attn"],
                f"attention {rep}: {m['launches']} kernel 2 launches, "
                f"expected 2 x {exp['attn']} attn ops")
        require(out.dtype == torch.float32 and out.shape == (H, d)
                and bool(torch.isfinite(out).all()),
                f"attention {rep}: result {out.dtype} {tuple(out.shape)}")
        err = (out.cuda().double() - exact).abs().max().item()
        diff = (out - single).abs().max().item()
        require(err <= 2e-4 and diff <= 2e-4,
                f"attention {rep}: max err {err} vs float64, {diff} vs "
                f"phase 6's result (limit 2e-4)")
        row = hybrid_row(m, exp, 2 * mb, report,
                         groups if rep == "warm" else None)
        row["merge_s"] = m["stats"]["merge_seconds"]
        say("hybrid", f"attention {rep}: vs float64 on the card max abs err "
                      f"{err:.3g}, vs phase 6's single-device result "
                      f"{diff:.3g} (limit 2e-4 each); {m['launches']} = 2 x "
                      f"{exp['attn']} kernel 2 launches; host merge "
                      f"{1e3 * m['stats']['merge_seconds']:.3f} ms")
    out, m = hybrid_call(
        "attention entry point",
        lambda: ooc_attention(q, Kc, Vc, budget_bytes=1,
                              devices=hybrid_pair(mb)),
        report, None, CounterAttn())
    err = (out.cuda().double() - exact).abs().max().item()
    require(err <= 2e-4, f"ooc_attention(devices=): max err {err}")
    say("hybrid", f"ooc_attention(devices=[gpu0, phi0]): {m['call_s']:.4f} "
                  f"s call with its planning, max err vs float64 {err:.3g}")
    del exact


def hybrid_cholesky_case(gen, report):
    """``ooc_cholesky(devices=)`` at n = 8192, panel 2048: three hybrid
    trailing updates, each planned with the reference's default search;
    held to a float64 Cholesky on the card and compared with the same
    per-panel loop on ``backend="vmem"``."""
    from repro_torch.core import ooc_cholesky

    n, pw, mb = HYBRID_CHOL
    A = factor_input(gen, "cholesky", n)
    (L,), m = hybrid_call(
        "cholesky",
        lambda: (ooc_cholesky(A, panel=pw, budget_bytes=2 * mb,
                              devices=hybrid_pair(mb)),),
        report, "hybrid_cholesky", Counter1())
    factor_oracle("cholesky", A, (L,), n)
    t0 = time.perf_counter()
    loop = ooc_cholesky(A, panel=pw, budget_bytes=2 * mb, backend="vmem")
    loop_s = time.perf_counter() - t0
    same = torch.equal(L, loop)
    diff = (L - loop).abs().max().item()
    report["hybrid"].append({"path": "cholesky", "call_s": m["call_s"],
                             "launches": m["launches"],
                             "peak_bytes": m["peak_bytes"],
                             "vmem_loop_s": loop_s,
                             "equal_to_vmem_loop": same})
    say("hybrid", f"ooc_cholesky(devices=[gpu0, phi0] at {mb} B each) "
                  f"n={n} panel {pw}: {m['call_s']:.3f} s call with the "
                  f"three trailing updates' planning, {m['launches']} "
                  f"kernel 1 launches, peak {m['peak_bytes']} B; the same "
                  f"loop on backend='vmem' {loop_s:.3f} s; bit for bit "
                  f"equal to it: {same} (max diff {diff:.3g})")


def phase_hybrid(gen, report, A, B, C, host_out, params, syrk, attn):
    """Phase 12: hybrid co-execution, the reference's gpu0 + phi0 pair both
    on this card (two executors on their own streams, from two pool
    threads), on phase 3's, 4's and 6's inputs and results, then a hybrid
    Cholesky.  Returns the hybrid MMOOC plan."""
    t0 = time.perf_counter()
    hp = hybrid_gemm_case(report, A, B, C, host_out, params)
    hybrid_syrk_case(report, syrk)
    hybrid_attention_case(report, attn)
    hybrid_cholesky_case(gen, report)
    say("hybrid", f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return hp


# ---------------------------------------------------------------------------
# Phase 13: critical paths of the measured spans ([analyze] lines)
# ---------------------------------------------------------------------------
EXEC_MODES = ("issue_order", "concurrent")
# phase 13's kernel 1 and kernel 2 count keys, by path and mode
ANALYZE_K1 = tuple(f"analyze_{p}_{m}" for p in ("host", "host_bf16", "syrk",
                                                "cholesky", "lu")
                   for m in EXEC_MODES) \
    + ("analyze_hybrid_gemm", "analyze_profiled")
ANALYZE_K2 = tuple(f"analyze_attention_{m}" for m in EXEC_MODES)


def classes_text(ana):
    from repro_torch.obs.analyze import PATH_CLASSES

    return ", ".join(f"{c} {100 * ana.shares[c]:.1f} %"
                     for c in PATH_CLASSES if c in ana.shares)


def check_attribution(tag, ana, sched, spans):
    """Phase 13's own checks of a tolerance-matched attribution
    (``verify_reconciliation`` is defined for exact ones only): the path
    starts at the analysis's origin (the first span's start) and ends at
    the makespan, consecutive segments abut within the tolerance, their
    durations sum to the analysed window within it, and the attributed
    bytes, flops and ops equal ``schedule_stats``."""
    from repro_torch.core import schedule_stats

    p, tol = ana.path, ana.tolerance
    first = min(s[2] for s in spans)
    require(p[0].start == ana.origin == first and ana.origin >= 0.0,
            f"{tag}: path starts at {p[0].start}, origin {ana.origin}, "
            f"first span {first}")
    require(p[-1].end == ana.makespan,
            f"{tag}: path ends at {p[-1].end}, makespan {ana.makespan}")
    gap = max((abs(b.start - a.end) for a, b in zip(p, p[1:])),
              default=0.0)
    require(gap <= tol, f"{tag}: segments {gap} s apart, tolerance {tol}")
    total = sum(s.duration for s in p)
    require(abs(total - (ana.makespan - ana.origin)) <= tol,
            f"{tag}: path sums to {total} s, window "
            f"{ana.makespan - ana.origin} s")
    st = schedule_stats(sched)
    got = (ana.h2d_bytes, ana.d2h_bytes, ana.flops, ana.n_ops)
    want = (st["h2d_bytes"], st["d2h_bytes"], st["flops"], st["n_ops"])
    require(got == want, f"{tag}: attributed (h2d, d2h, flops, ops) {got}, "
                         f"schedule_stats {want}")
    return gap, total


def _merged(intervals):
    """Sorted disjoint union of (start, end) intervals, as two lists."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [s for s, _ in out], [e for _, e in out]


def _covered(merged, a, b):
    """Seconds of [a, b) that a :func:`_merged` union covers."""
    starts, ends = merged
    got = 0.0
    for i in range(max(bisect.bisect_right(starts, a) - 1, 0), len(starts)):
        if starts[i] >= b:
            break
        got += max(0.0, min(ends[i], b) - max(starts[i], a))
    return got


def path_evidence(ana):
    """What the attribution proves about its ``idle-wait`` segments.

    Re-walks the analysis's own backward walk (``_predecessor``, from the
    last span) and counts the rule behind each path link: ``stream``,
    ``event`` or ``engine`` when the predecessor ends where the op starts
    (within the tolerance; the engine rule exactly), ``fallback`` when the
    walk only found the latest dependency ending earlier.  Then splits the
    path's ``idle-wait`` seconds: ``contention_s``, while another op of
    the next path op's pool was busy (in ``concurrent`` mode a schedule
    stream's ops queue on each engine's one CUDA stream, and an op queued
    behind another is certified only when the two event times are equal
    floats); ``card_idle_s``, while no span at all was busy on the card;
    ``host_net_s``, the idle-wait less the contention — an upper bound on
    host wait, of which ``card_idle_s`` is a lower bound."""
    rules = dict.fromkeys(("stream", "event", "engine", "fallback"), 0)
    cur = max(ana._placed, key=lambda p: (p.end, -p.stream))
    while cur.start > ana.origin + ana.tolerance:
        pred, kind, _ = ana._predecessor(cur)
        if pred is None:
            break
        rules[kind if ana._ends_at(pred, cur.start) else "fallback"] += 1
        cur = pred
    busy = _merged((p.start, p.end) for p in ana._placed)
    pools = {pool: _merged((p.start, p.end) for p in ana._placed
                           if p.pool == pool)
             for pool in {p.pool for p in ana._placed}}
    placed = {(p.stream, p.op.tag, p.start): p for p in ana._placed}
    idle = contention = card_idle = 0.0
    for seg, nxt in zip(ana.path, ana.path[1:] + [None]):
        if seg.cls != "idle-wait":
            continue
        idle += seg.duration
        card_idle += seg.duration - _covered(busy, seg.start, seg.end)
        # the op after the wait starts where the wait ends, so its own
        # span adds nothing to its pool's cover of the wait
        op = nxt and placed.get((nxt.stream, nxt.tag, nxt.start))
        if op is not None:
            contention += _covered(pools[op.pool], seg.start, seg.end)
    return {"rules": rules, "idle_wait_s": idle,
            "contention_s": contention, "card_idle_s": card_idle,
            "host_net_s": idle - contention}


def attribution_row(tag, mode, ana, sched, spans, wall, stage, analysis_s,
                    report, card):
    """Check, print and keep (in ``report["analyze"]``) one measured
    call's attribution, with its :func:`path_evidence`."""
    gap, total = check_attribution(tag, ana, sched, spans)
    idle = ana.class_seconds.get("idle-wait", 0.0)
    window = ana.makespan - ana.origin
    ev = path_evidence(ana)
    require(abs(ev["idle_wait_s"] - idle) <= ana.tolerance,
            f"{tag} {mode}: idle-wait segments sum to {ev['idle_wait_s']} "
            f"s, the analysis says {idle} s")
    gaps = ana.top_gaps(3)
    row = {"path": tag, "mode": mode, "wall_s": wall,
           "makespan_s": ana.makespan, "origin_s": ana.origin,
           "tolerance_s": ana.tolerance, "verdict": ana.verdict,
           "shares": ana.shares, "class_seconds": ana.class_seconds,
           "stream_utilization": ana.stream_utilization(),
           "pool_busy_s": ana.busy_by_pool, "stage_s": stage,
           "idle_wait_s": idle, "path_segments": len(ana.path),
           "n_ops": ana.n_ops, "analysis_s": analysis_s,
           "top_gaps": [g.to_json() for g in gaps], "evidence": ev,
           "card": card}
    report["analyze"].append(row)
    say("analyze", f"{tag} {mode}: {ana.verdict}; critical path "
                   f"{classes_text(ana)} of {window:.4f} s ({len(ana.path)} "
                   f"segments; spans from {1e3 * ana.origin:.3f} ms, the "
                   f"call's executor wall {wall:.4f} s); streams "
                   + ", ".join(f"s{s.stream} {100 * s.utilization:.1f} %"
                               for s in ana.streams)
                   + "; pools " + ", ".join(
                       f"{k} {v:.4f} s" for k, v in
                       sorted(ana.busy_by_pool.items()))
                   + "; top gaps " + "; ".join(
                       f"s{g.stream} {1e3 * g.duration:.3f} ms before "
                       f"{g.next_tag or 'drain'} ({g.cause})" for g in gaps)
                   + f"; host staging fill {stage:.4f} s beside idle-wait "
                   f"{idle:.4f} s ({100 * idle / window:.1f} %), of which "
                   f"{ev['contention_s']:.4f} s with the next path op's "
                   f"pool busy and {ev['card_idle_s']:.4f} s with the card "
                   f"idle: host net of contention {ev['host_net_s']:.4f} s "
                   f"({100 * ev['host_net_s'] / window:.1f} %); path links "
                   + ", ".join(f"{k} {v}" for k, v in ev["rules"].items())
                   + "; "
                   f"{ana.n_ops} ops placed, bytes and flops = "
                   f"schedule_stats, segments abut within {gap:.3g} s and "
                   f"sum to the window within "
                   f"{abs(total - window):.3g} s (tolerance "
                   f"{ana.tolerance:.3g} s); analysis {analysis_s:.4f} s on "
                   f"the host")


def analyzed_call(tag, mode, run, sched, expect, count, report, card):
    """One path in one executor mode: a cold call on a new executor, then
    the recorded warm call, whose result must equal ``expect`` bit for bit
    and whose bytes must equal ``schedule_stats``; its spans attributed
    with ``TraceAnalysis.from_spans``.  ``count`` = (counter, key, the
    expected launches).  Returns (analysis, executor)."""
    from repro_torch.core import ScheduleExecutor, schedule_stats
    from repro_torch.obs.analyze import TraceAnalysis

    ex = ScheduleExecutor(mode=mode)
    run(ex)
    ex.record_spans = True
    counter, key, launches = count
    counter.zero()
    res = run(ex)
    counter.keep(report, key)
    got = counter.read()
    require(got == launches, f"{tag} {mode}: {got} launches, expected "
                             f"{launches}")
    require(all(torch.equal(a, b) for a, b in zip(res, expect)),
            f"{tag} {mode}: the recorded call differs from its phase's "
            f"result")
    st = schedule_stats(sched)
    require((ex.last_h2d_bytes, ex.last_d2h_bytes)
            == (st["h2d_bytes"], st["d2h_bytes"]),
            f"{tag} {mode}: moved {ex.last_h2d_bytes}/{ex.last_d2h_bytes} "
            f"B, schedule_stats says {st['h2d_bytes']}/{st['d2h_bytes']}")
    t0 = time.perf_counter()
    ana = TraceAnalysis.from_spans(sched, ex.last_spans)
    secs = time.perf_counter() - t0
    attribution_row(tag, mode, ana, sched, ex.last_spans,
                    ex.last_wall_seconds, ex.last_stage_seconds, secs,
                    report, card)
    return ana, ex


def profiled_call(ex, run, sched, expect, report, card):
    """One more warm recorded call of the bf16 MMOOC concurrent path under
    ``torch.profiler``: kernel 1's device time from ``key_averages()``
    beside the attribution's compute busy time, and the call's Chrome
    trace (``export_trace``'s ``measured_trace``) under ``chiprun_out/``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.block_matmul import block_matmul
    from repro_torch.obs.analyze import TraceAnalysis
    from repro_torch.scripts.export_trace import measured_trace

    zero_counts(block_matmul)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run(ex)
    launches = read_counts(block_matmul, report, "analyze_profiled")
    require(launches == dgemm_ops(sched),
            f"profiled call: {launches} launches, expected "
            f"{dgemm_ops(sched)}")
    require(all(torch.equal(a, b) for a, b in zip(res, expect)),
            "profiled call: differs from phase 7's result")
    ana = TraceAnalysis.from_spans(sched, ex.last_spans)
    check_attribution("profiled bf16 mmooc", ana, sched, ex.last_spans)
    k1_us, n_k1, dev_us = 0.0, 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        dev_us += t
        if "gemm_kernel" in evt.key:
            k1_us += t
            n_k1 += evt.count
    busy = ana.busy_by_pool.get("COMPUTE", 0.0)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "analyze_bf16_concurrent_trace.json")
    with open(path, "w") as f:
        json.dump(measured_trace(sched, ex.last_spans,
                                 "mmooc 24576^3 bf16 concurrent"), f)
    row = {"path": "profiled mmooc bf16 concurrent", "wall_s":
           ex.last_wall_seconds, "profiler_device_s": dev_us / 1e6,
           "profiler_kernel1_s": k1_us / 1e6, "profiler_kernel1_calls": n_k1,
           "analysis_compute_busy_s": busy, "verdict": ana.verdict,
           "shares": ana.shares, "trace": os.path.relpath(
               path, os.path.dirname(os.path.abspath(__file__))),
           "card": card}
    report["analyze"].append(row)
    if dev_us <= 0.0:
        say("analyze", "profiler cross-check: torch.profiler's "
                       "key_averages() show no device time on this machine; "
                       f"the attribution's compute busy {busy:.4f} s stands "
                       f"alone; trace {row['trace']}")
        return
    say("analyze", f"profiler cross-check (bf16 mmooc concurrent, "
                   f"{ex.last_wall_seconds:.4f} s executor wall under the "
                   f"profiler): kernel 1 {k1_us / 1e3:.3f} ms device time "
                   f"over {n_k1} kernel events ({launches} launches counted) "
                   f"beside the attribution's compute busy "
                   f"{1e3 * busy:.3f} ms (ratio {k1_us / 1e6 / busy:.4f}); "
                   f"all device time in the profile {dev_us / 1e3:.3f} ms; "
                   f"{ana.verdict}, {classes_text(ana)}; Chrome trace of "
                   f"the call written to {row['trace']}")


def phase_analyze(report, card, main_io, bf16_io, syrk, attn, factors,
                  hplan, tuned):
    """Phase 13: one extra warm call per path with ``record_spans=True``
    in both executor modes (MMOOC f32 and bf16, SYRK, attention, Cholesky,
    LU) and one hybrid MMOOC call, each bit for bit equal to its phase's
    result; ``TraceAnalysis.from_spans`` on each (phase 13's own checks),
    ``analyze_hybrid`` on phase 12's plan, ``whatif_plan`` on phase 11's
    tuned MMOOC and SYRK plans under the calibrated profile, one
    ``hclTraceAnalysis`` call, and the profiler cross-check."""
    from repro_torch.core import (HostOocRuntime, build_attention_schedule,
                                  build_gemm_schedule, build_syrk_schedule,
                                  compile_factor_pipeline, ooc_attention,
                                  ooc_gemm, ooc_syrk,
                                  plan_attention_partition,
                                  plan_gemm_partition)
    from repro_torch.core.api import hclTraceAnalysis
    from repro_torch.core.ooc_factor import _plan_factor_spec
    from repro_torch.hybrid import device_schedule, run_hybrid_gemm
    from repro_torch.hybrid.executor import analyze_hybrid, last_run_stats
    from repro_torch.obs.analyze import TraceAnalysis
    from repro_torch.obs.whatif import whatif_plan

    t_phase = time.perf_counter()
    k1, k2 = Counter1(), CounterAttn()
    A, B, C, host_out, params = main_io
    alpha, beta, budget = params
    M, K = A.shape
    N = B.shape[1]

    def mmooc(A, B, C, budget):
        return lambda ex: (ooc_gemm(A, B, C, alpha, beta,
                                    budget_bytes=budget, backend="host",
                                    nstreams=2, nbuf=2,
                                    runtime=HostOocRuntime(executor=ex)),)

    def gemm_sched(budget, bpe):
        return build_gemm_schedule(
            plan_gemm_partition(M, N, K, budget, bpe), nstreams=2, nbuf=2)

    cases = [("mmooc f32", "host", mmooc(A, B, C, budget),
              gemm_sched(budget, 4), (host_out,), k1)]
    Ah, Bh, Ch, bf16_out = bf16_io
    bsched = gemm_sched(TUNE_BF16_BUDGET, 2)
    cases.append(("mmooc bf16", "host_bf16",
                  mmooc(Ah, Bh, Ch, TUNE_BF16_BUDGET), bsched, (bf16_out,),
                  k1))
    P, Cs, syrk_out = syrk
    n, Ks = P.shape
    sbudget = TUNE_SYRK[2]
    cases.append(("syrk", "syrk", lambda ex: (ooc_syrk(
        P, Cs, -1.0, 0.5, budget_bytes=sbudget, backend="host",
        runtime=HostOocRuntime(executor=ex)),), build_syrk_schedule(
            plan_gemm_partition(n, n, Ks, sbudget, 4), nstreams=2, nbuf=2),
        (syrk_out,), k1))
    q, Kc, Vc, attn_out = attn
    S, hkv, d = Kc.shape
    abudget = TUNE_ATTN[4]
    apart = plan_attention_partition(S, hkv, d, abudget, Kc.element_size())
    cases.append(("attention long_500k bf16", "attention",
                  lambda ex: (ooc_attention(q, Kc, Vc, budget_bytes=abudget,
                                            nstreams=2, nbuf=2,
                                            executor=ex),),
                  build_attention_schedule(apart, hkv, d, q.shape[0],
                                           nstreams=2, nbuf=2),
                  (attn_out,), k2))
    nf, pw, fbudget = FACTOR_N, FACTOR_PANEL, FACTOR_BUDGET
    for kind in ("cholesky", "lu"):
        Af, first = factors[kind]
        spec = _plan_factor_spec(kind, nf, pw, fbudget, 4, 1, 2, "cuda")
        fsched = compile_factor_pipeline(spec, nstreams=2, nbuf=2)
        ctx = {"alpha": -1.0, "beta": 1.0, "panel": spec.panel, "n": spec.n}

        def factor(ex, Af=Af, fsched=fsched, ctx=ctx, kind=kind):
            out = Af.clone()
            st = ex.run(fsched, {}, {"A": out}, ctx)
            return (torch.tril(out),) if kind == "cholesky" \
                else (out, st.scratch["perm"])

        cases.append((f"{kind} n={nf}", kind, factor, fsched, first, k1))

    kept = {}     # what the facade and the profiler reuse, by path
    for tag, key, run, sched, expect, counter in cases:
        want = dgemm_ops(sched) if counter is k1 else \
            2 * apart.nblocks + 1
        for mode in EXEC_MODES:
            ana, ex = analyzed_call(
                tag, mode, run, sched, expect,
                (counter, f"analyze_{key}_{mode}", want), report, card)
            if mode == "concurrent" and key in ("host", "host_bf16"):
                kept[key] = (ana, ex)
            del ex

    # the facade on the same spans gives the same attribution
    ana, ex = kept.pop("host")
    same = hclTraceAnalysis(cases[0][3], spans=ex.last_spans)
    require(same.to_json() == ana.to_json(),
            "hclTraceAnalysis(spans=) differs from TraceAnalysis.from_spans")
    say("analyze", "hclTraceAnalysis(sched, spans=) on the f32 concurrent "
                   "call's spans == TraceAnalysis.from_spans, key for key")

    # both members of phase 12's hybrid MMOOC (their executors are kept
    # across calls, so this call is warm)
    exp_ops = sum(dgemm_ops(device_schedule(hplan, dp))
                  for dp in hplan.device_plans)
    k1.zero()
    out, groups = run_hybrid_gemm(A, B, C, alpha, beta, hplan,
                                  record_spans=True)
    k1.keep(report, "analyze_hybrid_gemm")
    require(k1.read() == exp_ops, f"hybrid: {k1.read()} launches, "
                                  f"expected {exp_ops}")
    require(torch.equal(out, host_out),
            "hybrid: the recorded call differs from phase 3's result")
    st = last_run_stats()
    spans = dict(groups)
    pred = analyze_hybrid(hplan)
    for dp in hplan.device_plans:
        name = dp.device.name
        sched = device_schedule(hplan, dp)
        t0 = time.perf_counter()
        ana = TraceAnalysis.from_spans(sched, spans[name])
        secs = time.perf_counter() - t0
        attribution_row(f"hybrid mmooc member {name}", "concurrent", ana,
                        sched, spans[name], st["device_walls"][name],
                        st["device_stage_seconds"][name], secs, report,
                        card)
        p = pred.device(name)
        say("analyze", f"hybrid member {name}: predicted (canned profile, "
                       f"exact) {p.verdict}, {classes_text(p)} over "
                       f"{p.makespan:.4g} s; measured {ana.verdict}")
    report["analyze"].append({
        "path": "analyze_hybrid (predicted)", "makespan_s": pred.makespan,
        "critical_device": pred.critical_device,
        "imbalance": pred.imbalance,
        "devices": {name: {"verdict": a.verdict, "shares": a.shares,
                           "makespan_s": a.makespan}
                    for name, a in pred.per_device}})
    say("analyze", f"analyze_hybrid on phase 12's plan (canned profiles): "
                   f"critical member {pred.critical_device}, imbalance "
                   f"{100 * pred.imbalance:.2f} %, predicted makespan "
                   f"{pred.makespan:.4g} s; measured lag "
                   f"{st['lag_seconds']:.4f} s of {st['wall_seconds']:.4f} s")
    del out

    # the what-if tables of phase 11's tuned plans under the profile
    # calibrate() measured on this card
    profile, plans = tuned
    for key, plan in sorted(plans.items()):
        rep = whatif_plan(plan, profile)
        report["analyze"].append({"path": f"whatif {key}", **rep.to_json(),
                                  "card": card})
        ranked = rep.ranked()
        require(rep.baseline.makespan > 0 and ranked,
                f"whatif {key}: no feasible scenario")
        say("analyze", f"whatif_plan({key} tuned plan, calibrated "
                       f"profile): baseline s{plan.nstreams}b{plan.nbuf} "
                       f"{rep.baseline.makespan:.4g} s predicted; "
                       + "; ".join(f"{s.name} {1e3 * s.gain_seconds:+.2f} ms"
                                   f" ({s.speedup:.3f}x)" for s in ranked)
                       + "; infeasible: " + (", ".join(
                           s.name for s in rep.scenarios if not s.feasible)
                           or "none"))

    # the profiler cross-check on the bf16 concurrent executor (warm)
    _, ex = kept.pop("host_bf16")
    profiled_call(ex, cases[1][2], bsched, (bf16_out,), report, card)
    say("analyze", f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


def phase_vmem_syrk(gen, report, A, B, C, host_out, params):
    from repro_torch.core import ooc_gemm, ooc_syrk, build_syrk_schedule, \
        plan_gemm_partition, HostOocRuntime, ScheduleExecutor
    from repro_torch.kernels.block_matmul import block_matmul

    alpha, beta, budget = params
    Ad, Bd, Cd = A.cuda(), B.cuda(), C.cuda()
    zero_counts(block_matmul)
    vout = ooc_gemm(Ad, Bd, Cd, alpha, beta, budget_bytes=budget,
                    backend="vmem")
    require(read_counts(block_matmul, report, "vmem") == 1,
            "vmem backend is not one launch")
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
    zero_counts(block_matmul)
    out = ooc_syrk(P, Cs, -1.0, 0.5, budget_bytes=sbudget, backend="host",
                   runtime=HostOocRuntime(executor=ex))
    require(read_counts(block_matmul, report, "syrk_host")
            == dgemm_ops(sched),
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
    return P, Cs, out


def interleaved(fns, reps):
    """Warm walls (s) of each named call, run in turns A B C A B C ...;
    each call ends with its result on the host or a device synchronize."""
    walls = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            del out
    return walls


def c1_rows(size, walls, report, floor=None):
    """Median and min-max of each variant, (API - floor) / floor and
    direct / API, printed and kept; with the floor's runtime, also its
    executor's own wall in its last run (the call's wall less planning,
    the copy of C and the result's allocation)."""
    med = {k: statistics.median(v) for k, v in walls.items()}
    for name, v in walls.items():
        say("c1", f"{size} {name:15s}: median {med[name]:.4f} s, min "
                  f"{min(v):.4f}, max {max(v):.4f} over {len(v)} warm runs "
                  f"({', '.join(f'{x:.4f}' for x in v)})")
    row = {"size": size, "walls_s": walls, "median_s": med}
    if "floor" in med:
        row["api_overhead"] = (med["api"] - med["floor"]) / med["floor"]
        row["direct_over_api"] = med["direct"] / med["api"]
        say("c1", f"{size}: (API - floor) / floor = "
                  f"{100 * row['api_overhead']:+.2f} %, direct / API = "
                  f"{row['direct_over_api']:.4f}")
    if floor is not None:
        row["floor_executor_s"] = floor.executor.last_wall_seconds
        say("c1", f"{size}: the floor's last call took "
                  f"{walls['floor'][-1]:.4f} s, its executor run "
                  f"{row['floor_executor_s']:.4f} s of it")
    report["c1"].append(row)


def phase_c1(gen, report, A, B, C, host_out, params):
    """Claim C1 on the card: the library path against its zero-abstraction
    floor and the hand-written direct baseline, interleaved in one call."""
    from repro_torch import direct_impls as D
    from repro_torch.core import (HostOocRuntime, ScheduleExecutor,
                                  build_gemm_schedule, ooc_gemm,
                                  plan_gemm_partition, schedule_stats)
    from repro_torch.kernels.block_matmul import block_matmul

    alpha, beta, budget = params
    M, K = A.shape
    N = B.shape[1]
    part = plan_gemm_partition(M, N, K, budget, 4)
    stats = schedule_stats(build_gemm_schedule(part, nstreams=2, nbuf=2))
    ex = ScheduleExecutor()
    zero_counts(block_matmul)
    out = D.direct_host_ooc_gemm(A, B, C, alpha, beta, budget, executor=ex)
    require(read_counts(block_matmul, report, "direct_host")
            == part.h * part.w,
            f"direct host: {block_matmul.launches} launches, expected "
            f"{part.h * part.w}")
    require((ex.last_h2d_bytes, ex.last_d2h_bytes)
            == (14_495_514_624, 2_415_919_104)
            == (stats["h2d_bytes"], stats["d2h_bytes"]),
            f"direct host moved {ex.last_h2d_bytes}/{ex.last_d2h_bytes} B")
    require(torch.equal(out, host_out),
            "direct_host_ooc_gemm differs from ooc_gemm's host result")
    del out
    say("c1", f"direct_host_ooc_gemm {M}^3 under {budget / 2**30:.0f} GiB: "
              f"{report['launches']['direct_host']} kernel-1 launches, "
              f"{ex.last_h2d_bytes} B H2D and {ex.last_d2h_bytes} B D2H (= "
              f"ooc_gemm's schedule_stats), == phase 3's host result bitwise")

    floor = None

    def variants(A, B, C, budget, part):
        nonlocal floor
        sched = build_gemm_schedule(part, nstreams=2, nbuf=2)
        floor = HostOocRuntime()
        conc = HostOocRuntime(executor=ScheduleExecutor(mode="concurrent"))
        return {
            "api": lambda: ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget,
                                    backend="host", validate=False),
            "floor": lambda: floor.gemm(A, B, C, alpha, beta, part,
                                        schedule=sched),
            "direct": lambda: D.direct_host_ooc_gemm(A, B, C, alpha, beta,
                                                     budget),
            "api_concurrent": lambda: ooc_gemm(
                A, B, C, alpha, beta, budget_bytes=budget, backend="host",
                validate=False, runtime=conc),
        }

    fns = variants(A, B, C, budget, part)
    for name, fn in fns.items():          # warm-up, checked
        require(torch.equal(fn(), host_out),
                f"C1 {name} differs from phase 3's host result")
    c1_rows(f"{M}^3", interleaved(fns, reps=3), report, floor)
    say("c1", f"{M}^3: warm-ups of api, floor, direct, api_concurrent == "
              f"phase 3's host result bitwise")

    m, n, k = 1536, 1024, 512
    a, b, c = (rand(s, gen, device="cpu") for s in ((m, k), (k, n), (m, n)))
    small = (a.nbytes + b.nbytes + c.nbytes) // 5
    spart = plan_gemm_partition(m, n, k, small, 4)
    incore = block_matmul(a.cuda(), b.cuda(), c.cuda(), alpha=alpha,
                          beta=beta).cpu()
    fns = variants(a, b, c, small, spart)
    for name, fn in fns.items():
        require(torch.equal(fn(), incore),
                f"C1 {m}x{n}x{k} {name} differs from the in-core launch")
    c1_rows(f"{m}x{n}x{k}", interleaved(fns, reps=15), report, floor)
    say("c1", f"{m}x{n}x{k} under {small} B ({spart.h}x{spart.w} blocks of "
              f"{spart.bm}x{spart.bn}): every variant == the in-core launch "
              f"bitwise")

    n3 = 8192
    Ad, Bd, Cd = (rand((n3, n3), gen) for _ in range(3))
    vbudget = 3 * Ad.nbytes // 5
    zero_counts(D.direct_vmem_ooc_gemm)
    dout = D.direct_vmem_ooc_gemm(Ad, Bd, Cd, alpha, beta)
    torch.cuda.synchronize()
    require(read_counts(D.direct_vmem_ooc_gemm, report, "direct_vmem") == 1,
            "direct_vmem_ooc_gemm is not one launch")
    saved = (D.direct_vmem_ooc_gemm.launches, block_matmul.launches)
    lout = ooc_gemm(Ad, Bd, Cd, alpha, beta, budget_bytes=vbudget,
                    backend="vmem")
    tol = 2 * sum_tol(Ad, Bd, Cd, alpha, beta)
    ref = D.direct_vmem_ooc_gemm_plain(Ad, Bd, Cd, alpha, beta)
    err = (dout - ref).abs()
    require(bool((err.double() <= tol).all()),
            f"direct_vmem {n3}^3: max err vs plain {err.max().item()}")
    require(torch.equal(dout, lout),
            f"vmem {n3}^3: kernel 3 differs from kernel 1 (max "
            f"{(dout - lout).abs().max().item()})")
    del ref, err, tol, lout, dout
    walls = interleaved({
        "api_vmem": lambda: ooc_gemm(Ad, Bd, Cd, alpha, beta,
                                     budget_bytes=vbudget, backend="vmem"),
        "direct_vmem": lambda: D.direct_vmem_ooc_gemm(Ad, Bd, Cd, alpha,
                                                      beta)}, reps=5)
    D.direct_vmem_ooc_gemm.launches, block_matmul.launches = saved
    c1_rows(f"vmem {n3}^3", walls, report)
    med = report["c1"][-1]["median_s"]
    say("c1", f"vmem {n3}^3 f32 on the card: direct (kernel 3) / API "
              f"(kernel 1) = {med['direct_vmem'] / med['api_vmem']:.4f}; "
              f"kernel 3 vs plain within 2*sqrt(K)*u*sum|terms|; kernel 3 "
              f"== kernel 1 bitwise; 1 launch")
    del Ad, Bd, Cd


def attn_oracle(q, Kd, Vd):
    """Float64 attention on the card, one kv head at a time."""
    H, d = q.shape
    hkv = Kd.shape[1]
    G = H // hkv
    exact = torch.empty((H, d), dtype=torch.float64, device=Kd.device)
    qd = q.to(Kd.device).double()
    for kh in range(hkv):
        rows = slice(kh * G, (kh + 1) * G)
        s = (qd[rows] @ Kd[:, kh].double().T) / math.sqrt(d)
        exact[rows] = torch.softmax(s, dim=-1) @ Vd[:, kh].double()
    return exact


def attention_case(gen, report, S, dt, budget, tag, keep=None):
    """``ooc_attention`` at llama3.2-3b's attention widths over an S-position
    cache in ``dt`` under ``budget``: both modes, cold and warm, all
    checks.  Returns the launches of both passes over the runs; ``keep``
    (a list) receives q, K, V and the result."""
    from repro_torch.core import (OpKind, ScheduleExecutor,
                                  build_attention_schedule, ooc_attention,
                                  plan_attention_partition, schedule_stats)
    from repro_torch.kernels import flash_attention as kfa

    H, hkv, d = 24, 8, 128
    t0 = time.perf_counter()
    K = rand((S, hkv, d), gen, dt, device="cpu")
    V = rand((S, hkv, d), gen, dt, device="cpu")
    q = rand((H, d), gen, device="cpu")
    bpe = K.element_size()
    kv_bytes = 2 * K.numel() * bpe
    part = plan_attention_partition(S, hkv, d, budget, bpe)
    sched = build_attention_schedule(part, hkv, d, H, nstreams=2, nbuf=2)
    stats = schedule_stats(sched)
    h2d = [op.bytes for op in sched.ops if op.kind == OpKind.H2D]
    n_attn = sum(1 for op in sched.ops if op.kind == OpKind.COMPUTE)
    blk = part.bs * hkv * d * bpe
    require(h2d == [blk] * (2 * part.nblocks) and n_attn == part.nblocks
            and stats["h2d_bytes"] == kv_bytes
            and stats["d2h_bytes"] == H * d * bpe,
            f"{tag}: schedule has H2D {h2d[:3]}..., {n_attn} attn ops, "
            f"stats {stats}")
    nsplit = kfa.nsplits(part.bs, 512)
    scratch = (2 * H + H * d + H * d + H * d          # carry, q, final
               + nsplit * H * (d + 2)) * 4             # partials
    parity = 4 * blk
    slack = 2 * 2**20                                  # allocator rounding
    say("attn", f"{tag}: K, V {S}x{hkv}x{d} {str(dt)[6:]} "
                f"({kv_bytes / 2**30:.2f} GiB, {kv_bytes / budget:.1f}x the "
                f"{budget / 2**20:.0f} MiB budget) and q {H}x{d} f32 made "
                f"from seed {SEED} in {time.perf_counter() - t0:.1f} s; "
                f"{part.nblocks} blocks of {part.bs}; {len(h2d)} H2D ops of "
                f"{blk} B, {n_attn} attn ops, one {stats['d2h_bytes']} B "
                f"finalize; schedule_stats {json.dumps(stats)}")

    outs = {}
    launches = {"partial": 0, "combine": 0}
    for mode in ("issue_order", "concurrent"):
        ex = ScheduleExecutor(mode=mode)
        for rep in ("cold", "warm"):
            ex.record_spans = rep == "warm"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            mallocs = torch.cuda.memory_stats()["num_device_alloc"]
            kfa.flash_partial.launches = 0
            kfa.flash_combine.launches = 0
            out = ooc_attention(q, K, V, budget_bytes=budget, nstreams=2,
                                nbuf=2, executor=ex)
            n_part = kfa.flash_partial.launches
            n_comb = kfa.flash_combine.launches
            peak = torch.cuda.max_memory_allocated() - base
            mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
            launches["partial"] += n_part
            launches["combine"] += n_comb
            require(n_part == part.nblocks and n_comb == part.nblocks + 1,
                    f"{tag} {mode}: {n_part} partial / {n_comb} combine "
                    f"launches, expected {part.nblocks} / "
                    f"{part.nblocks + 1}")
            require(ex.last_h2d_bytes == stats["h2d_bytes"]
                    and ex.last_d2h_bytes == stats["d2h_bytes"],
                    f"{tag} {mode}: moved {ex.last_h2d_bytes}/"
                    f"{ex.last_d2h_bytes} B, schedule_stats says "
                    f"{stats['h2d_bytes']}/{stats['d2h_bytes']}")
            require(peak <= parity + scratch + slack,
                    f"{tag} {mode}: peak device memory {peak} B above "
                    f"{parity} + {scratch} + {slack} B")
            require(out.dtype == torch.float32 and out.shape == (H, d)
                    and bool(torch.isfinite(out).all()),
                    f"{tag} {mode}: result {out.dtype} {tuple(out.shape)} "
                    f"not finite f32 ({H}, {d})")
            wall = ex.last_wall_seconds
            row = {"path": "attention", "case": tag, "mode": mode,
                   "run": rep, "wall_s": wall, "launches": n_part + n_comb,
                   "peak_bytes": peak, "h2d_bytes": ex.last_h2d_bytes,
                   "d2h_bytes": ex.last_d2h_bytes,
                   "stage_s": ex.last_stage_seconds,
                   "stage_wait_s": ex.last_stage_wait_seconds,
                   "cuda_mallocs": mallocs}
            if ex.last_spans:
                busy = {}
                for op, span in zip(sched.ops, ex.last_spans):
                    busy[op.kind] = busy.get(op.kind, 0.0) \
                        + span[3] - span[2]
                covered, reach = 0.0, 0.0   # union of the op spans
                for _, _, a, b in sorted(ex.last_spans, key=lambda x: x[2]):
                    covered += max(0.0, b - max(a, reach))
                    reach = max(reach, b)
                row["device_busy_s"] = {k.name: v for k, v in busy.items()}
                row["longest_attn_s"] = max(
                    b - a for op_tag, _, a, b in ex.last_spans
                    if op_tag.startswith("ATTN"))
                row["h2d_gbps"] = stats["h2d_bytes"] / busy[OpKind.H2D] / 1e9
                row["device_idle_share"] = 1.0 - covered / wall
            report["attention"].append(row)
            say("attn", f"{tag} {mode:11s} {rep}: {wall:.4f} s wall "
                        f"({kv_bytes / wall / 1e9:.1f} GB/s of KV end to "
                        f"end), {n_part} partial + {n_comb} combine "
                        f"launches, bytes = schedule_stats, peak "
                        f"{peak} B <= 4 x {blk} B parity buffers + {scratch} "
                        f"B carry/q/partials/final + {slack} B slack; "
                        f"{mallocs} cudaMalloc; host staging fill "
                        f"{ex.last_stage_seconds:.4f} s, staging wait "
                        f"{ex.last_stage_wait_seconds:.4f} s"
                        + (f"; compute busy "
                           f"{row['device_busy_s']['COMPUTE'] * 1e3:.3f} ms"
                           f" (longest attn op "
                           f"{row['longest_attn_s'] * 1e3:.3f} ms), H2D busy "
                           f"{row['device_busy_s']['H2D'] * 1e3:.2f} ms "
                           f"({row['h2d_gbps']:.1f} GB/s), device idle "
                           f"{100 * row['device_idle_share']:.1f} % of the "
                           f"wall" if "h2d_gbps" in row else ""))
            if rep == "cold":
                outs[mode] = out
    require(torch.equal(outs["issue_order"], outs["concurrent"]),
            f"{tag}: issue_order and concurrent results differ")
    out = outs["issue_order"].cuda()
    Kd, Vd = K.cuda(), V.cuda()
    exact = attn_oracle(q, Kd, Vd)
    err = (out.double() - exact).abs().max().item()
    mag = exact.abs().max().item()
    require(err <= 2e-4, f"{tag}: max err {err} vs float64 beyond 2e-4")
    whole = kfa.flash_decode_attention(q.cuda()[None], Kd[None], Vd[None],
                                       S)[0]
    werr = (out - whole).abs().max().item()
    require(werr <= 1e-5, f"{tag}: differs from the kernel on the whole "
                          f"cache by {werr}")
    say("attn", f"{tag}: issue_order == concurrent, bitwise; vs float64 "
                f"on the card: max abs err {err:.3g} (limit 2e-4) beside "
                f"max |out| {mag:.3g} (relative {err / mag:.3g}); vs "
                f"flash_decode_attention on the whole cache at B = 1: max "
                f"abs diff {werr:.3g} (limit 1e-5)")
    if keep is not None:
        keep.extend((q, K, V, outs["issue_order"]))
    return launches


def phase_attention(gen, report):
    """Phase 6; returns the long_500k cell's q, K, V and result."""
    cell = []
    report["launches"]["attention"] = attention_case(
        gen, report, 524288, torch.bfloat16, 512 * 2**20,
        "long_500k bf16", keep=cell)
    report["launches"]["attention_f32"] = attention_case(
        gen, report, 131072, torch.float32, 256 * 2**20, "S=131072 f32")
    return tuple(cell)


def phase_timing_attention(gen, report, card):
    from repro_torch.kernels import flash_attention as kfa

    peak_flops, peak_bw = datasheet(torch.cuda.get_device_name(0))
    shapes = []
    saved = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    # (name, B, cache positions S, valid length L, Hkv, G, d, q's dtype) at
    # llama3.2-3b's heads (Hkv 8, G 3, d 128) and zamba2-1.2b's (Hkv 32,
    # G 1, d 64); the last two are phase 14's decode steps (bf16 at batch
    # 4, prompt 512, gen 32: a 544-position cache, 528 valid at the middle
    # step)
    for name, B, S, L, hkv, G, d, qdt in (
            ("main path block", 1, 65536, 65536, 8, 3, 128, torch.float32),
            ("decode_32k at B/4", 32, 32768, 32768, 8, 3, 128,
             torch.float32),
            ("serve decode step", 4, 544, 528, 8, 3, 128, torch.bfloat16),
            ("zamba2 site decode step", 4, 544, 528, 32, 1, 64,
             torch.bfloat16)):
        H = hkv * G
        q = rand((B, H, d), gen, qdt)
        k, v = (rand((B, S, hkv, d), gen, torch.bfloat16) for _ in range(2))
        length = torch.full((B,), L, dtype=torch.int32, device="cuda")
        out = kfa.flash_decode_attention(q, k, v, length)
        ms = time_ms(lambda: kfa.flash_decode_attention(q, k, v, length),
                     reps=20, warmup=2)
        partial_ms = time_ms(lambda: kfa.flash_partial(q, k, v, length),
                             reps=20, warmup=2)
        ref = kfa.flash_decode_attention_plain(q, k, v, length)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if qdt == torch.float32:
            require(err <= 2e-4, f"timing {name}: kernel vs plain max err "
                                 f"{err}")
        else:       # a 16-bit output: phase 2's tolerance for its dtype
            tol = ATTN_TOL[qdt]
            require(bool((diff <= tol + tol * ref.float().abs()).all()),
                    f"timing {name}: kernel vs plain max err {err} beyond "
                    f"rtol=atol={tol}")
        plain_ms = time_ms(lambda: kfa.flash_decode_attention_plain(
            q, k, v, length), reps=3)
        del ref
        # the library yardstick: SDPA with GQA on the same K/V (as views in
        # its (B, heads, S, d) layout) and q in their dtype
        qs = q.to(torch.bfloat16)[:, :, None]
        ks, vs = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        choice = getattr(torch, "_fused_sdp_choice", None)
        backend = "not reported"
        if choice is not None:
            from torch.nn.attention import SDPBackend
            backend = SDPBackend(choice(qs, ks, vs, enable_gqa=True)).name
        lib_out = sdpa(qs, ks, vs, enable_gqa=True)[:, :, 0]
        lib_err = (lib_out.float() - out.float()).abs().max().item()
        library_ms = time_ms(lambda: sdpa(qs, ks, vs, enable_gqa=True),
                             reps=20, warmup=2)
        del lib_out
        # what the call needs: the valid K/V positions, q, out and length
        kv_bytes = 2 * B * L * hkv * d * k.element_size()
        nbytes = kv_bytes + q.numel() * q.element_size() \
            + out.numel() * out.element_size() + length.numel() * 4
        flops = 4 * B * H * L * d
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = flops / peak_flops * 1e3
        row = {"shape": name, "B": B, "S": S, "L": L, "Hkv": hkv, "G": G,
               "d": d, "kv_dtype": "bfloat16", "q_dtype": str(qdt)[6:],
               "ms": ms, "partial_ms": partial_ms,
               "combine_ms": ms - partial_ms,
               "gbps": nbytes / ms / 1e6,
               "partial_kv_gbps": kv_bytes / partial_ms / 1e6,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_backend": backend, "library_max_diff": lib_err,
               "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err}
        shapes.append(row)
        say("timing", f"flash_attention {name} (B={B}, S={S}, {L} valid, "
                      f"Hkv={hkv}, G={G}, d={d}, bf16 KV, q "
                      f"{str(qdt)[6:]}): {ms:.4f} ms/call (partial "
                      f"pass {partial_ms:.4f} ms at "
                      f"{row['partial_kv_gbps']:.0f} GB/s of K and V, "
                      f"combine {row['combine_ms']:.4f} ms), "
                      f"{row['gbps']:.0f} GB/s; bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                      f"{nbytes} B at {peak_bw / 1e12:.2f} TB/s, data "
                      f"sheet); plain {plain_ms:.3f} ms; SDPA enable_gqa "
                      f"({backend}) {library_ms:.4f} ms, its max diff "
                      f"{lib_err:.3g} (q in bf16); kernel vs plain max "
                      f"err {err:.3g}; card {card}")
        del q, k, v, qs, ks, vs, out
    kfa.flash_partial.launches, kfa.flash_combine.launches = saved
    a = shapes[0]
    la = report["launches"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": sum(la[c]["partial"] + la[c]["combine"]
                        for c in ATTENTION_PATHS),
        "launches_by_pass": {c: la[c] for c in ATTENTION_PATHS},
        "max_abs_err": a["max_abs_err"], "ms": a["ms"],
        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        "shapes": shapes,
    }


TIMING_SHAPE = (6144, 6144, 24576)     # one MMOOC block, whole K


def gemm_bound(dt):
    """(bound ms, what bounds it, flops, peak FLOP/s) of one GEMM at the
    timing shape in ``dt``: bytes (each operand read once, out written
    once) at the HBM rate, operations at the data-sheet peak of ``dt``'s
    unit (CUDA cores in f32, tensor cores in 16 bits)."""
    M, N, K = TIMING_SHAPE
    esize = torch.empty((), dtype=dt).element_size()
    flops = 2 * M * N * K + 3 * M * N
    nbytes = (M * K + K * N + 2 * M * N) * esize
    peak_flops, peak_bw = datasheet(torch.cuda.get_device_name(0), dt)
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / peak_bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, peak_flops)


def gemm_err(out, ref, A, B, C, alpha, beta):
    """Max |out - ref|, required within f32's summation bound (twice
    sqrt(K) * u * sum|terms|) or the reference's 16-bit 2e-2."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        ok = bool((err.double() <= 2 * sum_tol(A, B, C, alpha, beta)).all())
    else:
        ok = bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all())
    require(ok, f"timing shape {out.dtype}: max err {err.max().item()} "
                f"against the plain version")
    return err.max().item()


def time_block_matmul(gen, dt, card):
    """Kernel 1 at the timing shape in ``dt``, beside its bound, its plain
    version and ``torch.addmm`` in the same dtype.  In bf16 also with A one
    element off a 16-byte boundary, which takes the tensor-core kernel's
    element-copy producer route instead of TMA (its result checked equal
    bit for bit)."""
    from repro_torch.kernels.block_matmul import block_matmul, \
        block_matmul_plain

    M, N, K = TIMING_SHAPE
    alpha, beta = 1.5, 0.5
    A, B, C = (rand(s, gen, dt) for s in ((M, K), (K, N), (M, N)))
    out = torch.empty_like(C)
    launches = block_matmul.launches
    reps = 5 if dt == torch.float32 else 20
    ms = time_ms(lambda: block_matmul(A, B, C, alpha=alpha, beta=beta,
                                      out=out), reps=reps)
    unaligned_ms = None
    if dt == torch.bfloat16:
        Au = torch.empty(M * K + 1, dtype=dt, device="cuda")[1:].view(M, K)
        Au.copy_(A)
        out_u = torch.empty_like(C)
        unaligned_ms = time_ms(lambda: block_matmul(
            Au, B, C, alpha=alpha, beta=beta, out=out_u), reps=5)
        require(torch.equal(out_u, out),
                f"timing shape {dt}: A off 16 bytes (element-copy route) "
                f"differs from the TMA route")
        del Au, out_u
    block_matmul.launches = launches   # timing launches are not the path's
    plain_ms = time_ms(lambda: block_matmul_plain(A, B, C, alpha=alpha,
                                                  beta=beta), reps=3)
    library_ms = time_ms(lambda: torch.addmm(C, A, B, beta=beta,
                                             alpha=alpha), reps=reps)
    ref = block_matmul_plain(A, B, C, alpha=alpha, beta=beta)
    bound_ms, bound_by, flops, peak = gemm_bound(dt)
    row = {"dtype": str(dt)[6:], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "max_abs_err": gemm_err(out, ref, A, B, C, alpha, beta)}
    if unaligned_ms is not None:
        row["unaligned_a_ms"] = unaligned_ms
    unit = "f32 CUDA cores" if dt == torch.float32 else \
        f"{str(dt)[6:]} tensor cores"
    say("timing", f"block_matmul {M}x{N}x{K} {str(dt)[6:]}: {ms:.3f} "
                  f"ms/launch ({flops / ms / 1e9:.2f} TFLOP/s), bound "
                  f"{bound_ms:.3f} ms ({bound_by}: {peak / 1e12:.0f} TFLOP/s "
                  f"{unit}, data sheet), plain {plain_ms:.3f} ms, "
                  f"torch.addmm {str(dt)[6:]} {library_ms:.3f} ms "
                  f"({ms / library_ms:.3f}x); kernel vs plain max err "
                  f"{row['max_abs_err']:.3g}"
                  + (f"; A one element off 16 bytes (element-copy route) "
                     f"{unaligned_ms:.3f} ms, == the TMA route bitwise"
                     if unaligned_ms is not None else "") + f"; card {card}")
    return row


def launches_of(report, paths, dt):
    """A kernel instance's launches in the main path's runs: its wrapper's
    count for dtype ``dt`` on each path, and their sum."""
    by_path = {k: report["launches_by_dtype"][k].get(dt, 0) for k in paths}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


# phase 14 (the serving path):
# parts (a) and (e): float32 at full depth, teacher-forced: arch, batch,
# prompt, max_len (= prompt + decode steps)
SERVE_F32 = ("llama3.2-3b", 2, 64, 96)
SSM_F32 = (("rwkv6-1.6b", 2, 64, 96), ("zamba2-1.2b", 2, 64, 96))
# parts (c)-(d) and (f): launch/serve.main in bf16: arch, batch, prompt, gen
SERVE_CASES = (("llama3.2-3b", 4, 512, 32), ("qwen2.5-3b", 4, 512, 32),
               ("deepseek-moe-16b", 4, 128, 8))
SSM_CASES = (("rwkv6-1.6b", 4, 512, 32), ("zamba2-1.2b", 4, 512, 32))
# the decode paths that launch kernel 2, each driven with its counts at 0
# (RWKV6's paths launch it no time: their counts are kept beside these)
SERVE_PATHS = ("serve_llama3.2-3b_f32",) + tuple(
    f"serve_{arch}" for arch, *_ in SERVE_CASES) + (
    "serve_zamba2-1.2b_f32", "serve_zamba2-1.2b")
DECODE_TOL = 2e-3          # tests/test_models.py's decode vs forward
PROFILE_STEPS = 8          # decode steps under torch.profiler

# phase 18's paths that launch kernel 1 (the in-core references of its
# results, then (a), (b) on each side, (c))
CLAIMS_K1 = ("claims_in_core", "claims_c2", "claims_c3_library",
             "claims_c3_vendor", "claims_c5")
# the paths that launch kernel 1, each driven with its counts set to 0
BLOCK_MATMUL_PATHS = ("host", "in_core", "vmem", "syrk_host", "direct_host",
                      "host_bf16", "in_core_bf16", "cholesky", "lu",
                      "fault_host", "fault_host_empty", "fault_host_oom",
                      "fault_cholesky", "fault_cholesky_oom", "fault_lu",
                      "tune_calibrate", "tune_gemm", "tune_gemm_bf16",
                      "tune_syrk", "tune_cholesky", "tune_lu", "tune_oom",
                      "hybrid_gemm", "hybrid_gemm_lost_gpu0",
                      "hybrid_gemm_lost_phi0", "hybrid_syrk",
                      "hybrid_cholesky") + ANALYZE_K1 + (
                          "mesh", "mesh_direct", "mesh_bfloat16",
                          "mesh_direct_bfloat16") + CLAIMS_K1
# the paths that launch kernel 2
ATTENTION_PATHS = ("attention", "attention_f32", "tune_attention",
                   "hybrid_attention") + ANALYZE_K2 + SERVE_PATHS + (
                       "seq_decode",)


def phase_timing(gen, report, card):
    f32, bf16, f16 = (time_block_matmul(gen, dt, card) for dt in (
        torch.float32, torch.bfloat16, torch.float16))
    common = {"route": "cuda",
              "source": "src/repro_torch/csrc/block_matmul.cu",
              "replaces": "src/repro/kernels/block_matmul.py:36"}
    return [
        {"name": "block_matmul", **common,
         **launches_of(report, BLOCK_MATMUL_PATHS, "float32"), **f32},
        {"name": "block_matmul_bf16", **common,
         **launches_of(report, BLOCK_MATMUL_PATHS, "bfloat16"), **bf16,
         "instances": {"float16": {
             **launches_of(report, BLOCK_MATMUL_PATHS, "float16"), **f16}}},
    ]


def phase_timing_direct(gen, report, card):
    """Kernel 3 at kernel 1's timing shape in f32 and bf16, beside its
    bound, its plain version, torch.addmm and kernel 1, timed in turns."""
    from repro_torch import direct_impls as D
    from repro_torch.kernels.block_matmul import block_matmul

    M, N, K = TIMING_SHAPE
    alpha, beta = 1.5, 0.5
    rows = {}
    saved = (D.direct_vmem_ooc_gemm.launches, block_matmul.launches)
    for dt in (torch.float32, torch.bfloat16):
        A, B, C = (rand(s, gen, dt) for s in ((M, K), (K, N), (M, N)))
        out = D.direct_vmem_ooc_gemm(A, B, C, alpha, beta)
        k1 = block_matmul(A, B, C, alpha=alpha, beta=beta)
        ref = D.direct_vmem_ooc_gemm_plain(A, B, C, alpha, beta)
        err = gemm_err(out, ref, A, B, C, alpha, beta)
        diff = (out.float() - k1.float()).abs().max().item()
        require(torch.equal(out, k1),
                f"timing shape {dt}: kernel 3 differs from kernel 1 (max "
                f"{diff})")
        del ref, k1, out
        reps = 3 if dt == torch.float32 else 20
        runs = {"direct": lambda: D.direct_vmem_ooc_gemm(A, B, C, alpha,
                                                         beta),
                "block_matmul": lambda: block_matmul(A, B, C, alpha=alpha,
                                                     beta=beta),
                "plain": lambda: D.direct_vmem_ooc_gemm_plain(A, B, C, alpha,
                                                              beta),
                "addmm": lambda: torch.addmm(C, A, B, beta=beta,
                                             alpha=alpha)}
        ms = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                ms[k].append(time_ms(runs[k], reps=3 if k == "plain"
                                     else reps))
        t = {k: statistics.mean(v) for k, v in ms.items()}
        bound_ms, bound_by, flops, _ = gemm_bound(dt)
        rows[dt] = {"dtype": str(dt)[6:], "max_abs_err": err,
                    "ms": t["direct"], "plain_ms": t["plain"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": t["addmm"],
                    "block_matmul_ms": t["block_matmul"],
                    "max_abs_diff_from_block_matmul": diff, "runs_ms": ms}
        say("timing", f"direct_vmem_gemm {M}x{N}x{K} {str(dt)[6:]}: "
                      f"{t['direct']:.3f} ms/launch "
                      f"({flops / t['direct'] / 1e9:.2f} TFLOP/s), bound "
                      f"{bound_ms:.3f} ms ({bound_by}), plain "
                      f"{t['plain']:.3f} ms, torch.addmm {t['addmm']:.3f} "
                      f"ms, kernel 1 in the same turns "
                      f"{t['block_matmul']:.3f} ms (kernel 3 / kernel 1 = "
                      f"{t['direct'] / t['block_matmul']:.4f}); runs "
                      f"{json.dumps(ms)}; kernel 3 vs plain max err "
                      f"{err:.3g}, kernel 3 == kernel 1 bitwise; card {card}")
        del A, B, C
    D.direct_vmem_ooc_gemm.launches, block_matmul.launches = saved
    return {
        "name": "direct_vmem_gemm", "route": "cuda",
        "source": "src/repro_torch/csrc/direct_vmem_gemm.cu",
        "replaces": "benchmarks/direct_impls.py:119",
        **launches_of(report, ("direct_vmem",), "float32"),
        **rows[torch.float32],
        "instances": {"bfloat16": {
            **launches_of(report, ("direct_vmem",), "bfloat16"),
            **rows[torch.bfloat16]}},
    }


class kernels_from:
    """Within the block, the kernel wrappers launch the libraries built from
    ``csrc`` (another checkout's sources of the same C interface) instead
    of this tree's."""

    def __init__(self, csrc):
        self.csrc = csrc

    def __enter__(self):
        from repro_torch.kernels import _build

        self.build, self.load = _build, _build.load
        _build.load = lambda name: self.load(name, self.csrc)

    def __exit__(self, *exc):
        self.build.load = self.load


def mmooc_turns(A, B, C, params, csrc):
    """The executor walls of ``ooc_gemm``'s host backend on this tree's
    kernels and on those built from ``csrc``, in turns (this, base, this,
    base, base, this) in each executor mode.  Returns a row a mode."""
    from repro_torch.core import HostOocRuntime, ScheduleExecutor, ooc_gemm

    alpha, beta, budget = params
    dt = str(A.dtype)[6:]
    rows = []
    for mode in ("issue_order", "concurrent"):
        walls = {"this": [], "base": []}
        exes = {w: ScheduleExecutor(mode=mode) for w in walls}
        for who in ("this", "base", "this", "base", "base", "this"):
            with (kernels_from(csrc) if who == "base"
                  else contextlib.nullcontext()):
                ooc_gemm(A, B, C, alpha, beta, budget_bytes=budget,
                         backend="host",
                         runtime=HostOocRuntime(executor=exes[who]))
            walls[who].append(exes[who].last_wall_seconds)
        # the first run of each is its cold run (pinned staging is new)
        warm = {w: v[1:] for w, v in walls.items()}
        rows.append({"kernel": "mmooc", "dtype": dt, "mode": mode,
                     "walls_s": walls})
        say("base", f"MMOOC {dt} {mode} executor walls (first of each "
                    f"cold): this "
                    f"{', '.join(f'{x:.3f}' for x in walls['this'])} s, base "
                    f"{', '.join(f'{x:.3f}' for x in walls['base'])} s; warm "
                    f"means this {statistics.mean(warm['this']):.3f} s, base "
                    f"{statistics.mean(warm['base']):.3f} s")
    return rows


def phase_baseline(gen, report, card, base, A, B, C, params):
    """Kernels 1 and 2 of another checkout (``base``, e.g. a ``git archive``
    of the parent commit) against this tree's, in one call on one card, in
    turns (this, base, base, this): kernel 1 at its timing shape in f32
    (outputs compared bit for bit) and bf16 (each tree's output within the
    reference's 2e-2 of the plain version, and this tree's equal to kernel
    3's: a base that sums bf16 on the CUDA cores and this tree's tensor
    cores round differently), kernel 2 at its two timing shapes, and the
    MMOOC walls of phase 3 in both executor modes."""
    from repro_torch import direct_impls as D
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.block_matmul import block_matmul, \
        block_matmul_plain

    csrc = os.path.join(os.path.abspath(base), "src", "repro_torch", "csrc")
    names = ("block_matmul", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        logs = list(pool.map(lambda n: _build.build(n, csrc), names))
    for name, log in zip(names, logs):
        say("base", f"{name} from {csrc} built in {log['seconds']:.2f} s")
    saved = (block_matmul.launches, kfa.flash_partial.launches,
             kfa.flash_combine.launches, D.direct_vmem_ooc_gemm.launches)

    def turns(fn_new, fn_base, reps, warmup=1):
        ms = {"this": [], "base": []}
        for who in ("this", "base", "base", "this"):
            if who == "this":
                ms[who].append(time_ms(fn_new, reps=reps, warmup=warmup))
            else:
                with kernels_from(csrc):
                    ms[who].append(time_ms(fn_base, reps=reps,
                                           warmup=warmup))
        return ms

    rows = []
    M = N = 6144
    K = 24576
    alpha, beta = 1.5, 0.5
    for dt in (torch.float32, torch.bfloat16):
        a, b, c = (rand(sh, gen, dt) for sh in ((M, K), (K, N), (M, N)))
        o_new, o_base = torch.empty_like(c), torch.empty_like(c)
        block_matmul(a, b, c, alpha=alpha, beta=beta, out=o_new)
        with kernels_from(csrc):
            block_matmul(a, b, c, alpha=alpha, beta=beta, out=o_base)
        torch.cuda.synchronize()
        if dt == torch.float32:
            require(torch.equal(o_new, o_base),
                    f"kernel 1 {dt} at {M}x{N}x{K} differs from the base's")
            same = "outputs bitwise equal"
        else:
            ref = block_matmul_plain(a, b, c, alpha=alpha, beta=beta).float()
            errs = [(o.float() - ref).abs() for o in (o_new, o_base)]
            require(all(bool((e <= 2e-2 + 2e-2 * ref.abs()).all())
                        for e in errs),
                    f"kernel 1 {dt}: max err vs plain "
                    f"{[e.max().item() for e in errs]} (this, base)")
            require(torch.equal(o_new,
                                D.direct_vmem_ooc_gemm(a, b, c, alpha, beta)),
                    f"kernel 1 {dt} at {M}x{N}x{K} differs from kernel 3")
            same = (f"max err vs plain {errs[0].max().item():.3g} (this), "
                    f"{errs[1].max().item():.3g} (base), within 2e-2; this "
                    f"== kernel 3 bitwise; this vs base max diff "
                    f"{(o_new.float() - o_base.float()).abs().max().item():.3g}")
            del ref, errs
        ms = turns(lambda: block_matmul(a, b, c, alpha=alpha, beta=beta,
                                        out=o_new),
                   lambda: block_matmul(a, b, c, alpha=alpha, beta=beta,
                                        out=o_base), reps=3)
        rows.append({"kernel": "block_matmul", "dtype": str(dt)[6:],
                     "shape": f"{M}x{N}x{K}", "ms": ms})
        say("base", f"block_matmul {str(dt)[6:]} {M}x{N}x{K}: this "
                    f"{statistics.mean(ms['this']):.3f} ms, base "
                    f"{statistics.mean(ms['base']):.3f} ms (turns "
                    f"{json.dumps(ms)}); {same}")
        del a, b, c, o_new, o_base

    hkv, G, d = 8, 3, 128
    for name, Bq, S in (("main path block", 1, 65536),
                        ("decode_32k at B/4", 32, 32768)):
        q = rand((Bq, hkv * G, d), gen)
        k, v = (rand((Bq, S, hkv, d), gen, torch.bfloat16) for _ in range(2))
        length = torch.full((Bq,), S, dtype=torch.int32, device="cuda")
        ref = kfa.flash_decode_attention_plain(q, k, v, length)
        with kernels_from(csrc):
            err_base = (kfa.flash_decode_attention(q, k, v, length)
                        - ref).abs().max().item()
        err = (kfa.flash_decode_attention(q, k, v, length)
               - ref).abs().max().item()
        require(err <= 2e-4 and err_base <= 2e-4,
                f"kernel 2 {name}: max err {err} (this), {err_base} (base)")
        del ref
        whole = turns(lambda: kfa.flash_decode_attention(q, k, v, length),
                      lambda: kfa.flash_decode_attention(q, k, v, length),
                      reps=20, warmup=2)
        part = turns(lambda: kfa.flash_partial(q, k, v, length),
                     lambda: kfa.flash_partial(q, k, v, length),
                     reps=20, warmup=2)
        rows.append({"kernel": "flash_attention", "shape": name, "B": Bq,
                     "S": S, "ms": whole, "partial_ms": part,
                     "max_abs_err": {"this": err, "base": err_base}})
        say("base", f"flash_attention {name} (B={Bq}, S={S}): this "
                    f"{statistics.mean(whole['this']):.4f} ms (partial "
                    f"{statistics.mean(part['this']):.4f}), base "
                    f"{statistics.mean(whole['base']):.4f} ms (partial "
                    f"{statistics.mean(part['base']):.4f}); turns "
                    f"{json.dumps(whole)} / {json.dumps(part)}; max err vs "
                    f"plain {err:.3g} / {err_base:.3g}")
        del q, k, v

    rows += mmooc_turns(A, B, C, params, csrc)
    (block_matmul.launches, kfa.flash_partial.launches,
     kfa.flash_combine.launches, D.direct_vmem_ooc_gemm.launches) = saved
    report["baseline"] = {"base": os.path.abspath(base), "card": card,
                          "rows": rows}


# ---------------------------------------------------------------------------
# Phase 14: the model zoo's serving path ([serve] lines)
# ---------------------------------------------------------------------------


def free_card():
    """Hands the memory the last part freed back from PyTorch's allocator
    pool to the card, so the next model starts from an empty pool."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def cache_bytes(cache, keys=None):
    """Bytes of a cache's tensors (all but ``len``, or ``keys``)."""
    keys = [k for k in cache if k != "len"] if keys is None else keys
    return sum(cache[k].numel() * cache[k].element_size() for k in keys
               if k in cache)


def attention_calls(model):
    """Kernel 2's calls in one decode step: one per attention layer, that is
    every layer of a transformer, every shared-attention site of Zamba2,
    none in the attention-free families."""
    family = model.cfg.family
    if family == "hybrid":
        return model.n_sites
    return 0 if family == "ssm" else model.cfg.num_layers


def attention_unit(model):
    return "site" if model.cfg.family == "hybrid" else "layer"


def serve_teacher_forced(report, card, arch, B, P, S, key, part):
    """(a) / (e) ``arch`` in f32 at full depth: prefill P tokens with room
    for S, then S - P teacher-forced decode steps, each step's logits
    within 2e-3 of ``forward``'s at that position; kernel 2's passes
    launch once per attention layer (:func:`attention_calls`) and step."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import get_model

    cfg = get_arch(arch).replace(param_dtype="float32", act_dtype="float32")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = get_model(cfg).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():                 # serving: no graph
        full = model.forward(toks)                              # (B, S, V)
    torch.cuda.synchronize()
    t_forward = time.perf_counter() - t0
    steps = S - P
    kfa.flash_partial.launches = kfa.flash_combine.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks[:, :P], max_len=S)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    errs = [(logits - full[:, P - 1]).abs().max()]
    excess = [((logits - full[:, P - 1]).abs()
               - DECODE_TOL * full[:, P - 1].abs()).max()]
    t0 = time.perf_counter()
    for i in range(P, S):
        logits, cache = model.decode(cache, toks[:, i])
        diff = (logits - full[:, i]).abs()
        errs.append(diff.max())
        excess.append((diff - DECODE_TOL * full[:, i].abs()).max())
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n_part, n_comb = kfa.flash_partial.launches, kfa.flash_combine.launches
    report["launches"][key] = {"partial": n_part, "combine": n_comb}
    calls, unit = attention_calls(model), attention_unit(model)
    expect = calls * steps
    require(n_part == expect and n_comb == expect,
            f"serve {arch} f32: {n_part} partial / {n_comb} combine "
            f"launches, expected {expect} each ({calls} {unit}s x {steps} "
            f"steps)")
    errs = torch.stack(errs).tolist()
    worst_excess = torch.stack(excess).max().item()
    require(worst_excess <= DECODE_TOL and all(map(math.isfinite, errs)),
            f"serve {arch} f32: decode logits beyond rtol=atol={DECODE_TOL} "
            f"of forward's (max abs errs {errs})")
    require(cache["len"].tolist() == [S] * B,
            f"serve {arch} f32: cache length {cache['len'].tolist()}, "
            f"expected {S}")
    row = {"part": part, "arch": arch, "dtype": "float32", "B": B,
           "prompt": P, "steps": steps, "layers": cfg.num_layers,
           "param_bytes": param_bytes(model), "init_s": t_init,
           "forward_s": t_forward, "prefill_s": t_prefill,
           "decode_step_ms": t_decode / steps * 1e3,
           "max_abs_err_prefill": errs[0], "max_abs_err_decode": max(errs[1:]),
           "launches": {"partial": n_part, "combine": n_comb}}
    report["serve"].append(row)
    say("serve", f"({part}) {arch} f32, {cfg.num_layers} layers "
                 f"({row['param_bytes'] / 1e9:.2f} GB of weights, drawn "
                 f"from seed {SEED} in {t_init:.1f} s): forward B={B} x {S} "
                 f"tokens {t_forward * 1e3:.1f} ms, prefill B={B} x {P} "
                 f"tokens {t_prefill * 1e3:.1f} ms, {steps} teacher-forced "
                 f"decode steps at {row['decode_step_ms']:.2f} ms each; "
                 f"logits vs forward max abs err {errs[0]:.3g} (prefill), "
                 f"{max(errs[1:]):.3g} (decode), within rtol=atol="
                 f"{DECODE_TOL}; kernel 2 launched {n_part} partial + "
                 f"{n_comb} combine = {calls} {unit}s x {steps} steps each; "
                 f"card {card}")
    del model, full, cache, logits, toks


def decode_step_kernel2_inputs(model, cache, tok):
    """One ``model.decode`` step with kernel 2's wrapper watched: returns
    the step's logits and cache and, by attention layer (a transformer's
    layer, a Zamba2 site), kernel 2's inputs (q, K, V, length) at the first
    and the last, cloned; none for a model without attention."""
    from repro_torch.kernels import ops as kops

    real, calls = kops.flash_decode_attention, []

    def capture(q, k, v, length, **kw):
        if len(calls) > 1:
            calls[-1] = None            # keep the first and the latest layer
        calls.append((q.clone(), k.clone(), v.clone(), length.clone()))
        return real(q, k, v, length, **kw)

    kops.flash_decode_attention = capture
    try:
        logits, cache = model.decode(cache, tok)
    finally:
        kops.flash_decode_attention = real
    expect = attention_calls(model)
    require(len(calls) == expect,
            f"serve {model.cfg.name}: {len(calls)} decode attention calls in "
            f"one step, expected {expect} ({attention_unit(model)}s)")
    if not calls:
        return logits, cache, {}
    return logits, cache, {0: calls[0], len(calls) - 1: calls[-1]}


def kernel2_vs_plain(tag, q, k, v, length):
    """Kernel 2 on one layer's decode inputs against its plain version and
    the plain mirror of the reference's ``decode_attention`` (q as the model
    gives it, bf16: phase 2's bf16 tolerance), and with q in float32
    against the plain version at phase 6's 2e-4.  The launches made here
    are not the path's: the counts are put back."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import layers as TL

    saved = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    tol = ATTN_TOL[q.dtype]
    out = kfa.flash_decode_attention(q, k, v, length)
    plain = kfa.flash_decode_attention_plain(q, k, v, length)
    mirror = TL.decode_attention(q, k, v, length)
    out32 = kfa.flash_decode_attention(q.float(), k, v, length)
    plain32 = kfa.flash_decode_attention_plain(q.float(), k, v, length)
    kfa.flash_partial.launches, kfa.flash_combine.launches = saved
    errs = {}
    for name, a, b, lim in (("plain", out, plain, tol),
                            ("mirror", out, mirror, tol),
                            ("plain_q_f32", out32, plain32, 2e-4)):
        diff = (a.float() - b.float()).abs()
        require(a.dtype == b.dtype and bool(
            (diff <= lim + lim * b.float().abs()).all()),
            f"{tag}: kernel 2 vs {name} max err {diff.max().item()} beyond "
            f"rtol=atol={lim}")
        errs[name] = diff.max().item()
    return errs


def kernel2_rows(arch, calls, card, part, unit="layer"):
    """:func:`kernel2_vs_plain` at each captured attention layer (``unit``:
    a transformer's layer, a Zamba2 site): its rows and one ``[serve]``
    line each."""
    rows = []
    for layer, (q, k, v, length) in calls.items():
        errs = kernel2_vs_plain(f"serve {arch} {unit} {layer}", q, k, v,
                                length)
        rows.append({unit: layer, "q": list(q.shape), "kv": list(k.shape),
                     "length": length.tolist(), **{
                         f"max_abs_err_{k_}": e for k_, e in errs.items()}})
        say("serve", f"({part}) {arch} bf16 decode step, {unit} {layer}: q "
                     f"{tuple(q.shape)} {str(q.dtype)[6:]}, K/V "
                     f"{tuple(k.shape)} {str(k.dtype)[6:]}, length "
                     f"{length.tolist()}: kernel 2 vs plain max err "
                     f"{errs['plain']:.3g}, vs the reference's rounding "
                     f"(plain mirror) {errs['mirror']:.3g} (rtol=atol="
                     f"{ATTN_TOL[q.dtype]}); with q in f32 vs plain "
                     f"{errs['plain_q_f32']:.3g} (2e-4); card {card}")
    return rows


def serve_kernel_vs_plain(report, card):
    """(b) One bf16 decode step of llama3.2-3b (B 2, 65 of 96 positions):
    kernel 2 against its plain versions at layers 0 and 27
    (:func:`kernel2_vs_plain`)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import get_model

    saved = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    cfg = get_arch("llama3.2-3b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = get_model(cfg).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                         device="cuda")
    _, cache = model.prefill(toks[:, :64], max_len=96)
    _, _, calls = decode_step_kernel2_inputs(model, cache, toks[:, 64])
    del model, cache
    kfa.flash_partial.launches, kfa.flash_combine.launches = saved
    report["serve"].append({"part": "b", "arch": "llama3.2-3b",
                            "dtype": "bfloat16",
                            "layers": kernel2_rows("llama3.2-3b", calls,
                                                   card, "b")})


def plain_kept(eidx, C, E):
    """The capacity rule written plainly: assignment (token t, its j-th
    expert) keeps a slot iff fewer than ``C`` of its group's assignments
    before it, in (token, choice) order, went to the same expert.
    eidx (G, Tg, k) -> kept (G, Tg, k) bool."""
    G, Tg, k = eidx.shape
    onehot = torch.nn.functional.one_hot(eidx.reshape(G, Tg * k).long(), E)
    before = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    return (before < C).reshape(G, Tg, k)


def route_plain(x, router, top_k, cf, groups):
    """The router's top-k on x (B, S, D), as ``moe_apply`` picks them, on
    x's device; then :func:`plain_kept` on the CPU.  Returns kept."""
    B, S, D = x.shape
    G = groups or B
    Tg, E = B * S // G, router.shape[1]
    C = min(-(-math.ceil(Tg * top_k / E * cf) // 16) * 16, Tg * top_k)
    logits = x.reshape(G, Tg, D).float() @ router.float()
    eidx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1).indices
    return plain_kept(eidx.cpu(), C, E)


def moe_witness(model, prompts, inputs, kept):
    """What decides the prefill's capacity drops.  ``inputs`` holds each
    layer's (router, MoE input, groups) from the prefill, ``kept`` the
    port's kept masks.  (i) The plain capacity rule on the card's own
    top-k must give every layer's kept mask exactly; (ii) layer 0 routed
    wholly on the CPU (float32 router product) gives the same drop share;
    (iii) layer 0's router on other inputs of the same shape: i.i.d.
    N(0, 1) rows, and the prompts' own embeddings under layer 0's
    ``mlp_norm``; (iv) how alike a group's MoE inputs are (cosine of each
    token's to its group's mean) and how much of layer 0's input is the
    token's embedding (cosine of the two)."""
    from repro_torch.models import layers as TL

    cfg = model.cfg
    k, cf = cfg.num_experts_per_tok, cfg.capacity_factor

    def share(m):
        return 1.0 - m.float().mean().item()

    for i, ((router, x, groups), kp) in enumerate(zip(inputs, kept)):
        plain = route_plain(x, router, k, cf, groups)
        require(torch.equal(plain, kp.cpu()),
                f"serve {cfg.name} layer {i}: the port's capacity dispatch "
                f"kept {int(kp.sum())} assignments, the plain rule "
                f"{int(plain.sum())}, {int((plain != kp.cpu()).sum())} differ")
    router, x, groups = inputs[0]
    cpu = route_plain(x.cpu(), router.cpu(), k, cf, groups)
    differ = int((cpu != kept[0].cpu()).sum())
    require(abs(share(cpu) - share(kept[0])) <= 0.01,
            f"serve {cfg.name} layer 0: drop share {share(cpu):.4f} routed "
            f"on the CPU against {share(kept[0]):.4f} on the card")
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        SEED))
    emb = TL.rms_norm(model.top["embed"][prompts].to(cfg.adtype),
                      model.layers[0]["mlp_norm"], cfg.norm_eps)

    def cos_group(x):
        G = groups or x.shape[0]
        xg = x.float().reshape(G, -1, x.shape[-1])
        return torch.nn.functional.cosine_similarity(
            xg, xg.mean(1, keepdim=True), dim=-1).mean().item()

    return {"plain_rule_layers": len(inputs),
            "dropped_layer0_cpu": share(cpu), "layer0_cpu_differ": differ,
            "dropped_layer0_iid": share(route_plain(noise, router.cpu(), k,
                                                    cf, groups)),
            "dropped_layer0_embed": share(route_plain(emb, router, k, cf,
                                                      groups)),
            "cos_group_mean_layer0": cos_group(x),
            "cos_group_mean_last": cos_group(inputs[-1][1]),
            "cos_group_mean_embed": cos_group(emb),
            "cos_layer0_embed": torch.nn.functional.cosine_similarity(
                x.float(), emb.float(), dim=-1).mean().item()}


def raw_device_ops(prof):
    """Device time (us), device ops and, by name, [us, count] of a
    ``torch.profiler`` run, read from its raw events (fast where the
    profiler's own aggregation of hundreds of thousands of events is
    not)."""
    from torch.autograd import DeviceType

    total, n, by_name = 0.0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        us = e.duration_ns() / 1e3
        total += us
        n += 1
        slot = by_name.setdefault(e.name(), [0.0, 0])
        slot[0] += us
        slot[1] += 1
    return total, n, by_name


def device_times(prof):
    """Device time (us), device ops and kernel 2's time and ops in a
    ``torch.profiler`` run, and its device ops by self time (name, us,
    count), costliest first."""
    dev_us, n_events, by = raw_device_ops(prof)
    k2 = [v for k, v in by.items() if "flash_partial_kernel" in k
          or "flash_combine_kernel" in k]
    by_name = sorted(((k, us, c) for k, (us, c) in by.items()),
                     key=lambda r: -r[1])
    return (dev_us, n_events, sum(v[0] for v in k2), sum(v[1] for v in k2),
            by_name)


def profile_decode(model, prompts, gen, card, part):
    """The prefill and the first ``PROFILE_STEPS`` decode steps of
    ``serve.generate`` once more under ``torch.profiler`` (CUDA activity
    only, so the trace stays small), the prefill and the steps apart:
    device time and device ops of the prefill, and per step in all, in
    kernel 2's two passes and in the costliest device ops.  One more
    decode step then holds kernel 2 against its plain versions at the
    first and the last attention layer (:func:`kernel2_rows`).  For an MoE
    model, the share of assignments the capacity dropped in the prefill
    and in those steps, and :func:`moe_witness` on the prefill's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe as M

    cfg = model.cfg
    real, kept, inputs = M.moe_apply, [], []

    def counted(p, x, **kw):
        stats = {}
        y = real(p, x, stats=stats, **kw)
        kept.append(stats["kept"])
        if len(inputs) < cfg.num_layers:            # the prefill's layers
            inputs.append((p["router"], x.clone(), kw.get("groups")))
        return y

    M.moe_apply = counted
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as pre:
            logits, cache = model.prefill(prompts,
                                          max_len=prompts.shape[1] + gen)
            torch.cuda.synchronize()
        n_prefill = len(kept)
        tok = logits.argmax(-1)
        steps = min(gen - 1, PROFILE_STEPS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                logits, cache = model.decode(cache, tok)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
        _, cache, calls = decode_step_kernel2_inputs(model, cache, tok)
    finally:
        M.moe_apply = real
    require(not cfg.is_moe or len(kept) == cfg.num_layers * (steps + 2),
            f"serve {cfg.name}: moe_apply ran {len(kept)} times, expected "
            f"{cfg.num_layers} layers x (prefill + {steps + 1} steps)")
    pre_us, pre_events, _, _, _ = device_times(pre)
    dev_us, n_events, k2_us, k2_calls, by_name = device_times(prof)
    out = {"profiled_steps": steps,
           "prefill_device_ms": pre_us / 1e3,
           "prefill_device_events": pre_events,
           "device_ms_per_step": dev_us / steps / 1e3,
           "device_events_per_step": n_events / steps,
           "kernel2_ms_per_step": k2_us / steps / 1e3,
           "kernel2_events": k2_calls,
           "top_device_ops_per_step": [
               {"op": name[:80], "ms": t / steps / 1e3,
                "count": c / steps} for name, t, c in by_name[:5]],
           "kernel2_vs_plain": kernel2_rows(cfg.name, calls, card, part,
                                            attention_unit(model))}
    if kept:
        def dropped(ks):
            n = sum(k.numel() for k in ks)
            return 1.0 - sum(int(k.sum()) for k in ks) / n
        out["dropped_prefill"] = dropped(kept[:n_prefill])
        out["dropped_decode"] = dropped(kept[n_prefill:])
        out["dropped_prefill_by_layer"] = [dropped([k])
                                           for k in kept[:n_prefill]]
        out["moe_witness"] = moe_witness(model, prompts, inputs,
                                         kept[:n_prefill])
    return out


def dispatch_us(n=2000):
    """Host time of one small CUDA op on this machine: ``n`` in-place adds
    on a 4-element tensor issued back to back, wall over ``n`` (the card
    finishes each long before the next arrives)."""
    t = torch.zeros(4, device="cuda")
    for _ in range(100):
        t.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        t.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def serve_main_case(report, card, arch, batch, prompt, gen, key, op_us,
                    part):
    """(c)/(d)/(f) ``launch/serve.main`` in bf16 at full width and depth;
    ``op_us`` is the host time of one small CUDA op (:func:`dispatch_us`)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve

    _, peak_bw = datasheet(torch.cuda.get_device_name(0))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kfa.flash_partial.launches = kfa.flash_combine.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", arch, "--batch", str(batch), "--prompt-len",
                      str(prompt), "--gen", str(gen), "--seed", str(SEED),
                      "--device", "cuda"])
    t_main = time.perf_counter() - t0
    n_part, n_comb = kfa.flash_partial.launches, kfa.flash_combine.launches
    report["launches"][key] = {"partial": n_part, "combine": n_comb}
    peak = torch.cuda.max_memory_allocated() - base
    model, cache = res["model"], res["cache"]
    cfg = model.cfg
    calls, unit = attention_calls(model), attention_unit(model)
    steps = gen - 1
    expect = calls * steps
    require(n_part == expect and n_comb == expect,
            f"serve {arch}: {n_part} partial / {n_comb} combine launches, "
            f"expected {expect} each ({calls} {unit}s x {steps} decode "
            f"steps)")
    require(res["tokens"].shape == (batch, gen),
            f"serve {arch}: tokens {res['tokens'].shape}")
    pbytes, cbytes = param_bytes(model), cache_bytes(cache)
    kv_bytes = cache_bytes(cache, ("k", "v"))
    state_bytes = cbytes - kv_bytes          # h, conv, M, last_t, last_c
    ebytes = model.top["embed"].numel() * model.top["embed"].element_size()
    step_ms = res["decode_s"] / steps * 1e3
    # a step reads every weight but the embedding table (B rows of it), the
    # cache's valid K/V (mean length over the steps), and reads and writes
    # the recurrent state once
    kv_read = kv_bytes // (prompt + gen) * (prompt + gen / 2)
    floor_w_ms = pbytes / peak_bw * 1e3
    floor_ms = (pbytes - ebytes + kv_read + 2 * state_bytes) / peak_bw * 1e3
    t0 = time.perf_counter()
    prof = profile_decode(model, res["prompts"], gen, card, part)
    t_prof = time.perf_counter() - t0
    row = {"part": part, "arch": arch,
           "dtype": str(cfg.adtype)[6:], "B": batch, "prompt": prompt,
           "gen": gen, "layers": cfg.num_layers,
           "attention_calls_per_step": calls,
           "prefill_ms": res["prefill_s"] * 1e3, "decode_ms":
           res["decode_s"] * 1e3, "decode_step_ms": step_ms,
           "tok_per_s": res["tput"], "param_bytes": pbytes,
           "embed_bytes": ebytes, "cache_bytes": cbytes,
           "kv_bytes": kv_bytes, "state_bytes": state_bytes,
           "floor_weights_ms": floor_w_ms, "floor_read_ms": floor_ms,
           "peak_bytes": peak, "decode_mallocs": res["decode_mallocs"],
           "launches": {"partial": n_part, "combine": n_comb},
           "host_us_per_device_op": step_ms * 1e3
           / prof["device_events_per_step"], "dispatch_us": op_us,
           "main_s": t_main,
           "profile_s": t_prof, **prof}
    report["serve"].append(row)
    drop = ""
    if "dropped_prefill" in prof:
        drop = (f"; capacity dropped {prof['dropped_prefill']:.2%} of the "
                f"prefill's and {prof['dropped_decode']:.2%} of the decode "
                f"steps' "
                f"expert assignments (top-{cfg.num_experts_per_tok} of "
                f"{cfg.num_experts}, capacity factor {cfg.capacity_factor};"
                f" prefill by layer: first "
                f"{prof['dropped_prefill_by_layer'][0]:.2%}, last "
                f"{prof['dropped_prefill_by_layer'][-1]:.2%}, min "
                f"{min(prof['dropped_prefill_by_layer']):.2%}, max "
                f"{max(prof['dropped_prefill_by_layer']):.2%})")
        w = prof["moe_witness"]
        say("serve", f"(d) {arch} capacity drops: the plain capacity rule on "
                     f"the card's top-k gave all {w['plain_rule_layers']} "
                     f"prefill layers' kept sets exactly; layer 0 routed on "
                     f"the CPU drops {w['dropped_layer0_cpu']:.2%} "
                     f"({w['layer0_cpu_differ']} assignments differ from the "
                     f"card's); layer 0's router drops "
                     f"{w['dropped_layer0_iid']:.2%} of i.i.d. N(0, 1) "
                     f"inputs and {w['dropped_layer0_embed']:.2%} of the "
                     f"prompts' normed embeddings; cosine of a token's MoE "
                     f"input to its group's mean: layer 0 "
                     f"{w['cos_group_mean_layer0']:.3f}, last layer "
                     f"{w['cos_group_mean_last']:.3f}, embeddings "
                     f"{w['cos_group_mean_embed']:.3f}; of layer 0's input "
                     f"to the token's own embedding "
                     f"{w['cos_layer0_embed']:.3f}; card {card}")
    top = ", ".join(f"{o['op'][:48]} {o['ms']:.3f} ms x {o['count']:.0f}"
                    for o in prof["top_device_ops_per_step"])
    say("serve", f"({part}) launch/serve.main {arch} bf16, "
                 f"{cfg.num_layers} layers, B={batch} prompt={prompt} "
                 f"gen={gen}: prefill {row['prefill_ms']:.1f} ms (device "
                 f"busy {prof['prefill_device_ms']:.3f} ms in "
                 f"{prof['prefill_device_events']} device ops, profiled "
                 f"rerun), decode "
                 f"{row['decode_ms']:.1f} ms = {step_ms:.3f} ms/step, "
                 f"{res['tput']:.1f} tok/s; floor {floor_w_ms:.3f} ms/step "
                 f"({pbytes / 1e9:.3f} GB of weights at "
                 f"{peak_bw / 1e12:.2f} TB/s, data sheet), {floor_ms:.3f} "
                 f"ms counting only what a step moves (no embedding table, "
                 f"+ the valid K/V of {kv_bytes / 1e9:.3f} GB, + the "
                 f"{state_bytes / 1e9:.4f} GB recurrent state read and "
                 f"written); measured step / weight floor "
                 f"{step_ms / floor_w_ms:.2f}; torch.profiler over "
                 f"{prof['profiled_steps']} more decode steps: device busy "
                 f"{prof['device_ms_per_step']:.3f} ms/step "
                 f"({prof['device_ms_per_step'] / step_ms:.1%} of the "
                 f"measured step) in {prof['device_events_per_step']:.0f} "
                 f"device ops, so {row['host_us_per_device_op']:.1f} us of "
                 f"the step per op (one small op alone: {op_us:.1f} us); "
                 f"kernel 2 "
                 f"{prof['kernel2_ms_per_step']:.4f} ms/step "
                 f"({prof['kernel2_ms_per_step'] / step_ms:.2%} of the "
                 f"step, {prof['kernel2_events']} kernel events); peak "
                 f"device memory {peak / 1e9:.3f} GB against weights + "
                 f"cache {(pbytes + cbytes) / 1e9:.3f} GB; "
                 f"{res['decode_mallocs']} cudaMallocs over the decode loop; "
                 f"kernel 2 launched {n_part} + {n_comb} = {calls} {unit}s x "
                 f"{steps} steps each{drop}; costliest device ops a step: "
                 f"{top}; serve.main took {t_main:.1f} s, the profiled rerun "
                 f"{t_prof:.1f} s; card {card}")
    del res, model, cache


def phase_serve(report, card):
    """Phase 14: the model zoo's serving path at full width (parts a-f),
    each model freed before the next."""
    t0 = time.perf_counter()
    op_us = dispatch_us()
    say("serve", f"one small CUDA op (an in-place add on 4 elements, 2000 "
                 f"back to back) takes {op_us:.2f} us of host time; card "
                 f"{card}")
    parts = [("a", lambda: serve_teacher_forced(
        report, card, *SERVE_F32, SERVE_PATHS[0], "a")),
             ("b", lambda: serve_kernel_vs_plain(report, card))]
    for arch, *case in SERVE_CASES:
        part = "c" if arch == "llama3.2-3b" else "d"
        parts.append((arch, lambda a=arch, c=case, p=part: serve_main_case(
            report, card, a, *c, f"serve_{a}", op_us, p)))
    for arch, *case in SSM_F32:
        parts.append((f"{arch}_f32", lambda a=arch, c=case: (
            serve_teacher_forced(report, card, a, *c, f"serve_{a}_f32",
                                 "e"))))
    for arch, *case in SSM_CASES:
        parts.append((arch, lambda a=arch, c=case: serve_main_case(
            report, card, a, *c, f"serve_{a}", op_us, "f")))
    took = {}
    for name, run in parts:
        t1 = time.perf_counter()
        free_card()
        run()
        took[name] = round(time.perf_counter() - t1, 1)
    free_card()
    say("serve", f"phase 14 took {time.perf_counter() - t0:.1f} s (by part "
                 f"{json.dumps(took)})")


# phase 15 (training): (a) the card's float32 step against the CPU's at
# full width and 2 layers; (b) launch/train.main at full width and depth;
# (c) the state-space families; (d) restart; (e) the train_lm example
TRAIN_CHECK = ("stablelm-1.6b", 2, 2, 64)          # arch, layers, B, S
TRAIN_MAIN = ("stablelm-1.6b", 8, 512, 3, 10)      # arch, B, S, warm, timed
TRAIN_PROFILE_STEPS = 2
TRAIN_SSM = (("rwkv6-1.6b", 4, 512), ("zamba2-1.2b", 4, 512))
# the reference tests' train-step optimizer: the first step at full lr
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)

# (d) in a process of its own: cuBLAS is deterministic only with its
# workspace fixed before its first call
RESTART_CODE = r"""
import json, sys, tempfile, time
import numpy as np, torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import main
times = {"save": [], "wait": [], "restore": []}
def timed(name, fn):
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        times[name].append(time.perf_counter() - t0)
        return out
    return run
CheckpointManager.save = timed("save", CheckpointManager.save)
CheckpointManager.wait = timed("wait", CheckpointManager.wait)
CheckpointManager.restore = timed("restore", CheckpointManager.restore)
args = ["--arch", "stablelm-1.6b", "--smoke", "--batch", "2", "--seq", "32",
        "--log-every", "100", "--device", "cuda"]
ck = tempfile.mkdtemp()
full = main(args + ["--steps", "14"])["losses"]
part1 = main(args + ["--steps", "7", "--total-steps", "14", "--ckpt-dir", ck,
                     "--ckpt-every", "7"])["losses"]
part2 = main(args + ["--steps", "14", "--ckpt-dir", ck, "--resume",
                     "auto"])["losses"]
print("RESTART " + json.dumps({"full": full, "resumed": part1 + part2,
                               "times": times}))
"""


def profiled(fn, steps=1):
    """``fn()`` ``steps`` times under ``torch.profiler`` (CUDA activity
    only): host seconds a call (ending in a device synchronise), device
    busy ms and device ops a call, and the costliest device ops a call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    dev_us, n, by_name = raw_device_ops(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / steps / 1e3,
            "device_ops": n / steps, "busy": dev_us / 1e3 / steps
            / (wall * 1e3),
            "top": [{"op": k[:80], "ms": v[0] / steps / 1e3,
                     "count": v[1] / steps} for k, v in top]}


def top_text(rows):
    return ", ".join(f"{o['op'][:48]} {o['ms']:.3f} ms x {o['count']:.0f}"
                     for o in rows)


def state_bytes(state):
    """Bytes of a train state's tensors (params and optimizer state)."""
    def leaves(t):
        for v in t.values():
            if isinstance(v, dict):
                yield from leaves(v)
            else:
                yield v
    return sum(t.numel() * t.element_size() for t in leaves(state))


def value_and_grads(model, batch):
    from repro_torch.training import steps as tsteps

    params = dict(model.named_parameters())
    loss = tsteps.build_loss_fn(model)(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def train_check(report, card):
    """(a) One float32 train step of stablelm-1.6b at full width and 2
    layers on the card against the same step on the CPU (the CPU path is
    held to the reference by the CPU tests): loss within 1e-5 relative,
    ``grad_norm`` within 1e-4, every gradient leaf within 1e-3 of its
    largest magnitude; then AdamW fed the CPU's gradients on both sides,
    the parameters within 1e-6."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.training import steps as tsteps

    arch, layers, B, S = TRAIN_CHECK
    cfg = get_arch(arch).replace(num_layers=layers, param_dtype="float32",
                                 act_dtype="float32")
    t0 = time.perf_counter()
    cpu = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED))
    gpu = get_model(cfg).init(torch.Generator(device="cuda"))
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("inputs", "labels")}
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, grads_c = value_and_grads(cpu, batch)
    t_cpu = time.perf_counter() - t0
    loss_g, grads_g = value_and_grads(gpu, {k: v.to("cuda")
                                            for k, v in batch.items()})
    norm_c = adamw.global_norm(grads_c.values())
    norm_g = adamw.global_norm(grads_g.values()).cpu()
    loss_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    norm_err = abs(norm_g.item() - norm_c.item()) / norm_c.item()
    leaf = {k: ((grads_g[k].cpu() - g).abs().max()
                / g.abs().max().clamp_min(1e-30)).item()
            for k, g in grads_c.items()}
    worst = max(leaf, key=leaf.get)
    require(loss_err <= 1e-5, f"train (a): loss {loss_g.item()} on the "
                              f"card, {loss_c.item()} on the CPU")
    require(norm_err <= 1e-4, f"train (a): grad_norm {norm_g.item()} on "
                              f"the card, {norm_c.item()} on the CPU")
    require(leaf[worst] <= 1e-3, f"train (a): gradient {worst} off by "
                                 f"{leaf[worst]:.3g} of its max")
    opt = AdamWConfig(**TRAIN_OPT)
    out = []
    for model, grads in ((cpu, grads_c),
                         (gpu, {k: g.to("cuda") for k, g in grads_c.items()})):
        state = tsteps.train_state(model, opt)
        adamw.update(grads, state["opt"], state["params"], opt)
        out.append(state["params"])
    p_err = max((out[1][k].detach().cpu() - p.detach()).abs().max().item()
                for k, p in out[0].items())
    require(p_err <= 1e-6, f"train (a): parameters after AdamW off by "
                           f"{p_err:.3g}")
    row = {"part": "a", "arch": arch, "layers": layers, "B": B, "S": S,
           "loss_card": loss_g.item(), "loss_cpu": loss_c.item(),
           "loss_rel_err": loss_err, "grad_norm_card": norm_g.item(),
           "grad_norm_cpu": norm_c.item(), "grad_norm_rel_err": norm_err,
           "worst_leaf": worst, "worst_leaf_err": leaf[worst],
           "param_err_after_adamw": p_err, "init_s": t_init,
           "cpu_step_s": t_cpu}
    report["train"].append(row)
    say("train", f"(a) {arch} f32 full width, {layers} layers, B={B} S={S}, "
                 f"TF32 off: loss card {loss_g.item():.7f} / CPU "
                 f"{loss_c.item():.7f} (rel {loss_err:.2g}, limit 1e-5), "
                 f"grad_norm {norm_g.item():.6f} / {norm_c.item():.6f} "
                 f"(rel {norm_err:.2g}, limit 1e-4), {len(leaf)} gradient "
                 f"leaves within {leaf[worst]:.2g} of their max (worst "
                 f"{worst}; limit 1e-3); AdamW on the same gradients: "
                 f"parameters within {p_err:.2g} (limit 1e-6); card {card}")
    del cpu, gpu, grads_c, grads_g, out


def train_main_case(report, card):
    """(b) ``launch/train.main`` on stablelm-1.6b at full width and depth,
    bf16 with the f32 master, warm steps then timed ones; then 2 more
    steps and one ``adamw.update`` under ``torch.profiler``."""
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, adamw

    arch, B, S, warm, timed = TRAIN_MAIN
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = datasheet(name, torch.bfloat16)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--steps", str(warm + timed),
                      "--batch", str(B), "--seq", str(S), "--seed",
                      str(SEED), "--log-every", "100", "--device", "cuda"])
    t_main = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    model, state, step = res["model"], res["state"], res["train_step"]
    cfg = model.cfg
    steps_ms = [s * 1e3 for s in res["step_s"][warm:]]
    med = statistics.median(steps_ms)
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.top["embed"].numel()
    T = B * S
    model_flops = 6 * (n_params - n_embed) * T
    tflops = model_flops / (med / 1e3) / 1e12
    sbytes = state_bytes(state)
    losses = res["losses"]
    require(all(map(math.isfinite, losses)), f"train (b): losses {losses}")
    require(losses[-1] < losses[0], f"train (b): loss did not fall: "
                                    f"{losses[0]} -> {losses[-1]}")
    src, it = res["source"], iter(range(warm + timed, 10**9))

    def one_step():
        b = src.batch_at(next(it), B, S)
        step(state, {k: torch.from_numpy(v).to("cuda") for k, v in b.items()})

    prof = profiled(one_step, TRAIN_PROFILE_STEPS)
    # AdamW alone, on one step's gradients: timed, then profiled
    b = src.batch_at(0, B, S)
    _, grads = value_and_grads(model, {k: torch.from_numpy(v).to("cuda")
                                       for k, v in b.items()})
    opt = AdamWConfig(lr=3e-4, total_steps=warm + timed,
                      warmup_steps=max(1, (warm + timed) // 10))
    upd = lambda: adamw.update(grads, state["opt"], state["params"],  # noqa
                               opt)
    upd_ms = time_ms(upd, reps=3, warmup=1)
    upd_prof = profiled(upd)
    grad_bytes = sum(g.numel() * g.element_size() for g in grads.values())
    # AdamW's floor: read the grads, read and write m, v, master, write
    # the params
    upd_bytes = grad_bytes + sum(
        t.numel() * t.element_size() * (2 if k != "params" else 1)
        for k, tree in (("m", state["opt"]["m"]), ("v", state["opt"]["v"]),
                        ("master", state["opt"]["master"]),
                        ("params", state["params"]))
        for t in tree.values())
    row = {"part": "b", "arch": arch, "dtype": str(cfg.pdtype)[6:],
           "layers": cfg.num_layers, "B": B, "S": S, "remat": cfg.remat,
           "params": n_params, "non_embedding_params": n_params - n_embed,
           "warm_steps": warm, "timed_steps": timed,
           "step_ms": steps_ms, "step_ms_median": med,
           "step_ms_min": min(steps_ms), "step_ms_max": max(steps_ms),
           "tokens_per_s": T / (med / 1e3), "model_tflops": tflops,
           "peak_share_bf16": tflops * 1e12 / peak_flops,
           "peak_bytes": peak, "state_bytes": sbytes,
           "loss_first": losses[0], "loss_last": losses[-1],
           "profile": prof, "adamw_ms": upd_ms, "adamw_profile": upd_prof,
           "adamw_floor_ms": upd_bytes / peak_bw * 1e3, "main_s": t_main}
    report["train"].append(row)
    say("train", f"(b) launch/train.main {arch} {row['dtype']} (f32 master), "
                 f"{cfg.num_layers} layers, {n_params / 1e9:.3f} B "
                 f"parameters ({(n_params - n_embed) / 1e9:.3f} B "
                 f"non-embedding), remat {cfg.remat}, B={B} S={S}: step "
                 f"{med:.2f} ms median of {timed} after {warm} warm "
                 f"(min {min(steps_ms):.2f}, max {max(steps_ms):.2f}), "
                 f"{T / (med / 1e3):.0f} tokens/s, model {tflops:.1f} "
                 f"TFLOP/s (6 N T) = {row['peak_share_bf16']:.1%} of the "
                 f"{peak_flops / 1e12:.0f} TFLOP/s bf16 peak (data sheet); "
                 f"peak device memory {peak / 1e9:.2f} GB against the "
                 f"train state's {sbytes / 1e9:.2f} GB; loss {losses[0]:.4f} "
                 f"-> {losses[-1]:.4f}; torch.profiler over "
                 f"{TRAIN_PROFILE_STEPS} more steps: {prof['wall_ms']:.2f} "
                 f"ms a step, device busy {prof['device_ms']:.2f} ms "
                 f"({prof['busy']:.1%}) in {prof['device_ops']:.0f} device "
                 f"ops; costliest: {top_text(prof['top'])}; adamw.update "
                 f"{upd_ms:.2f} ms (device busy {upd_prof['device_ms']:.2f} "
                 f"ms in {upd_prof['device_ops']:.0f} device ops; floor "
                 f"{row['adamw_floor_ms']:.2f} ms, {upd_bytes / 1e9:.1f} GB "
                 f"at {peak_bw / 1e12:.2f} TB/s); main took {t_main:.1f} s; "
                 f"card {card}")
    del res, model, state, step, grads, upd


def train_ssm_case(report, card, arch, B, S):
    """(c) one warm step through ``launch/train.main`` at full width and
    depth in bf16, then one timed step under ``torch.profiler``."""
    from repro_torch.launch import train

    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--steps", "1", "--batch", str(B),
                      "--seq", str(S), "--seed", str(SEED), "--log-every",
                      "100", "--device", "cuda"])
    t_main = time.perf_counter() - t0
    state, step, src = res["state"], res["train_step"], res["source"]
    cfg = res["model"].cfg
    out = {}

    def one_step():
        b = src.batch_at(1, B, S)
        _, m = step(state, {k: torch.from_numpy(v).to("cuda")
                            for k, v in b.items()})
        out["loss"] = m["loss"]

    prof = profiled(one_step)
    peak = torch.cuda.max_memory_allocated() - base
    losses = res["losses"] + [out["loss"].item()]
    require(all(map(math.isfinite, losses)), f"train (c) {arch}: {losses}")
    sbytes = state_bytes(state)
    row = {"part": "c", "arch": arch, "dtype": str(cfg.pdtype)[6:],
           "layers": cfg.num_layers, "B": B, "S": S, "remat": cfg.remat,
           "warm_step_ms": res["step_s"][0] * 1e3,
           "step_ms": prof["wall_ms"], "peak_bytes": peak,
           "state_bytes": sbytes, "losses": losses, "profile": prof,
           "main_s": t_main}
    report["train"].append(row)
    say("train", f"(c) {arch} {row['dtype']}, {cfg.num_layers} layers, "
                 f"B={B} S={S}, remat {cfg.remat}: warm step "
                 f"{row['warm_step_ms']:.0f} ms, timed step (under "
                 f"torch.profiler) {prof['wall_ms']:.0f} ms, device busy "
                 f"{prof['device_ms']:.0f} ms ({prof['busy']:.1%}) in "
                 f"{prof['device_ops']:.0f} device ops; costliest: "
                 f"{top_text(prof['top'])}; peak device memory "
                 f"{peak / 1e9:.2f} GB against the train state's "
                 f"{sbytes / 1e9:.2f} GB; losses {losses}; card {card}")
    del res, state, step


def child_env(**extra):
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "src")
    if os.environ.get("PYTHONPATH"):
        path += os.pathsep + os.environ["PYTHONPATH"]
    return {**os.environ, "PYTHONPATH": path, **extra}


def train_restart(report, card):
    """(d) the reference test's restart at the smoke size, on the card,
    under deterministic algorithms: 14 steps straight against 7 steps, a
    checkpoint and 7 resumed, the losses within rtol 1e-4."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", RESTART_CODE],
                         capture_output=True, text=True, timeout=300,
                         env=child_env(CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("RESTART ")]
    require(res.returncode == 0 and lines,
            f"train (d): the restart run failed (rc {res.returncode}): "
            f"{res.stderr[-3000:]}")
    out = json.loads(lines[-1][len("RESTART "):])
    full, resumed = out["full"], out["resumed"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full))
    require(len(full) == len(resumed) == 14 and rel <= 1e-4,
            f"train (d): resumed losses {resumed} against {full}")
    t = out["times"]
    row = {"part": "d", "losses": full, "resumed": resumed,
           "max_rel_diff": rel, "save_s": t["save"], "wait_s": t["wait"],
           "restore_s": t["restore"], "wall_s": wall}
    report["train"].append(row)
    say("train", f"(d) restart under torch.use_deterministic_algorithms: 14 "
                 f"steps straight against 7 + checkpoint + 7 resumed, "
                 f"losses within {rel:.2g} (limit rtol 1e-4); host snapshot "
                 f"{sum(t['save']):.3f} s over {len(t['save'])} saves, "
                 f"writes waited {sum(t['wait']):.3f} s, restore "
                 f"{sum(t['restore']):.3f} s; the process took {wall:.1f} "
                 f"s; card {card}")


def train_example(report, card):
    """(e) ``python -m repro_torch.examples.train_lm``: the 180 M-parameter
    run, 200 steps, in a process of its own with a fresh temp dir for its
    checkpoints."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.train_lm"],
            capture_output=True, text=True, timeout=600,
            env=child_env(TMPDIR=tmp))
        wall = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    require(res.returncode == 0 and lines and lines[-1] == "train_lm OK",
            f"train (e): train_lm failed (rc {res.returncode}): "
            f"{res.stdout[-2000:]} {res.stderr[-3000:]}")
    final = [ln for ln in lines if ln.startswith("final loss")]
    report["train"].append({"part": "e", "wall_s": wall,
                            "final": final[-1], "log": lines[:3]})
    say("train", f"(e) train_lm (180 M parameters, 200 steps, checkpoints "
                 f"every 50): {final[-1]}, ended 'train_lm OK' in "
                 f"{wall:.1f} s (a process of its own); first lines: "
                 f"{lines[:2]}; card {card}")


def phase_train(report, card):
    """Phase 15: the training path (parts a-e), each part's tensors freed
    before the next."""
    t0 = time.perf_counter()
    parts = [("a", lambda: train_check(report, card)),
             ("b", lambda: train_main_case(report, card))]
    for arch, B, S in TRAIN_SSM:
        parts.append((arch, lambda a=arch, b=B, s=S: train_ssm_case(
            report, card, a, b, s)))
    parts += [("d", lambda: train_restart(report, card)),
              ("e", lambda: train_example(report, card))]
    took = {}
    for name, run in parts:
        t1 = time.perf_counter()
        free_card()
        run()
        took[name] = round(time.perf_counter() - t1, 1)
    free_card()
    say("train", f"phase 15 took {time.perf_counter() - t0:.1f} s (by part "
                 f"{json.dumps(took)})")


# phase 16 (the MESH tier and the sharded model zoo, one NCCL rank)
MESH_TRAIN = ("stablelm-1.6b", 8, 512, 2, 3)   # arch, B, S, steps, timed
MESH_PARITY = (1e-5, 1e-4)    # tests/test_elastic.py: checksum, loss (rel)


def mesh_ring_case(report, card, mesh, tag, A, B, C, alpha, beta, want,
                   against):
    """(a)/(b) ``ooc_gemm(backend="mesh")`` and ``direct_mesh_ooc_gemm``
    on host operands at one rank: each one launch of kernel 1 and no
    transfer, bit for bit equal to ``want`` (an earlier phase's result)."""
    from repro_torch.core import MeshOocRuntime, ooc_gemm
    from repro_torch.direct_impls import direct_mesh_ooc_gemm
    from repro_torch.kernels.block_matmul import block_matmul

    dt = str(A.dtype)[6:]
    rt = MeshOocRuntime(mesh)
    rows = {}
    for name, run in (("tier", lambda: ooc_gemm(
            A, B, C, alpha, beta, budget_bytes=rt.mem_size(),
            backend="mesh", runtime=rt)),
            ("direct", lambda: direct_mesh_ooc_gemm(A, B, C, alpha, beta,
                                                    mesh))):
        key = f"mesh{'_direct' if name == 'direct' else ''}" + (
            "" if dt == "float32" else f"_{dt}")
        walls = []
        for i in range(2):              # cold (allocations), then warm
            zero_counts(block_matmul)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            local = out.to_local()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                n = read_counts(block_matmul, report, key)
            require(out.placements[0].is_shard(0)
                    and tuple(local.shape) == tuple(want.shape),
                    f"mesh {tag} {name}: placed {out.placements}, local "
                    f"{tuple(local.shape)}")
            require(torch.equal(local.cpu(), want),
                    f"mesh {tag} {name}: differs from {against}")
            del out, local
        rows[name] = {"wall_s": walls, "launches": n}
        require(n == 1, f"mesh {tag} {name}: {n} kernel-1 launches, not 1")
    p2p = rt.last_p2p_bytes
    require(p2p == 0, f"mesh {tag}: {p2p} P2P bytes at one rank")
    row = {"part": tag, "dtype": dt, "shape": list(A.shape) + [B.shape[1]],
           "p2p_bytes": p2p, "mem_bytes": rt.mem_size(), **rows}
    report["mesh"].append(row)
    say("mesh", f"({tag}) ooc_gemm(backend='mesh') {A.shape[0]}^3 {dt} at "
                f"one NCCL rank (tier memory {rt.mem_size() / 2**30:.1f} "
                f"GiB, the card's): wall cold {rows['tier']['wall_s'][0]:.3f}"
                f" s / warm {rows['tier']['wall_s'][1]:.3f} s (host operands "
                f"copied in, one product, result left on the card), kernel-1 "
                f"launches {rows['tier']['launches']}, P2P bytes {p2p}; "
                f"direct_mesh_ooc_gemm cold "
                f"{rows['direct']['wall_s'][0]:.3f} s / warm "
                f"{rows['direct']['wall_s'][1]:.3f} s, launches "
                f"{rows['direct']['launches']}; both == {against} bitwise; "
                f"card {card}")


def param_checksum(params) -> float:
    """Sum of |p| over every parameter, in float64 on the card."""
    return float(sum(t.full_tensor().double().abs().sum()
                     if hasattr(t, "full_tensor") else
                     t.detach().double().abs().sum()
                     for t in params.values()))


def fixed_loss(model, batch) -> float:
    from repro_torch.training import steps as tsteps
    with torch.no_grad():
        loss = tsteps.build_loss_fn(model)(batch)
    return float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss)


def mesh_train_case(report, card):
    """(c) ``launch/train.main`` with ``--mesh on`` (a one-rank (data,
    model) DeviceMesh, the state DTensors placed by ``tree_shardings``)
    beside the plain run, then (d) its state saved and restored onto plain
    tensors and back onto the mesh.  Returns the sharded run's state's
    parameter shapes for (e)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.distributed import tree_shardings
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import steps as tsteps

    arch, B, S, steps, timed = MESH_TRAIN
    args = ["--arch", arch, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--seed", str(SEED), "--log-every", "100",
            "--device", "cuda"]
    runs = {}
    for mode in ("off", "on"):
        free_card()
        t0 = time.perf_counter()
        res = train.main(args + ["--mesh", mode])
        t_main = time.perf_counter() - t0
        state, step, src = res["state"], res["train_step"], res["source"]
        params = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                  .detach().cpu() for k, v in state["params"].items()}
        place = train.to_device
        walls = []
        for i in range(timed):
            b = src.batch_at(steps + i, B, S)
            batch = place({k: torch.from_numpy(v) for k, v in b.items()},
                          torch.device("cuda"), res["mesh"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, m = step(state, batch)
            train.value(m["loss"])
            walls.append((time.perf_counter() - t1) * 1e3)
        runs[mode] = {"losses": res["losses"], "params": params,
                      "first_step_ms": res["step_s"][0] * 1e3,
                      "step_ms": walls, "main_s": t_main,
                      "placed": {type(v).__name__ for v in
                                 state["params"].values()}}
        if mode == "on":
            model, mesh = res["model"], res["mesh"]
            kept = (model, state, mesh, args)
        del res, state, step
    off, on = runs["off"], runs["on"]
    require(on["placed"] == {"DTensor"} and off["placed"] == {"Parameter"},
            f"mesh (c): state types {on['placed']} / {off['placed']}")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(off["losses"],
                                                       on["losses"]))
    leaf = {k: ((on["params"][k].float() - p.float()).abs().max()
                / p.float().abs().max().clamp_min(1e-30)).item()
            for k, p in off["params"].items()}
    worst = max(leaf, key=leaf.get)
    p_abs = max((on["params"][k].float() - p.float()).abs().max().item()
                for k, p in off["params"].items())
    require(loss_err <= 1e-5, f"mesh (c): losses {on['losses']} sharded, "
                              f"{off['losses']} plain")
    require(leaf[worst] <= 1e-3, f"mesh (c): parameter {worst} off by "
                                 f"{leaf[worst]:.3g} of its max")
    med = {k: statistics.median(runs[k]["step_ms"]) for k in runs}
    row = {"part": "c", "arch": arch, "B": B, "S": S, "steps": steps,
           "losses_plain": off["losses"], "losses_mesh": on["losses"],
           "loss_rel_err": loss_err, "param_max_abs_err": p_abs,
           "worst_leaf": worst, "worst_leaf_err": leaf[worst],
           "step_ms_plain": off["step_ms"], "step_ms_mesh": on["step_ms"],
           "first_step_ms_plain": off["first_step_ms"],
           "first_step_ms_mesh": on["first_step_ms"],
           "main_s_plain": off["main_s"], "main_s_mesh": on["main_s"]}
    report["mesh"].append(row)
    say("mesh", f"(c) launch/train.main {arch} bf16 full width and depth, "
                f"B={B} S={S}, {steps} steps on a one-rank (data, model) "
                f"mesh (state DTensors by tree_shardings) beside the plain "
                f"run: losses {on['losses']} vs {off['losses']} (max rel "
                f"{loss_err:.2g}, limit 1e-5); parameters max abs diff "
                f"{p_abs:.3g}, worst leaf {worst} {leaf[worst]:.2g} of its "
                f"max (limit 1e-3); step ms (median of {timed} after "
                f"{steps}) mesh {med['on']:.1f} vs plain {med['off']:.1f} "
                f"({med['on'] / med['off'] - 1:+.1%}: DTensor's cost a step "
                f"at one rank); first step mesh "
                f"{on['first_step_ms']:.0f} ms vs plain "
                f"{off['first_step_ms']:.0f} ms (sharding propagation "
                f"warm-up); card {card}")
    del runs, off, on

    # (d) re-sharding: save the sharded state, restore onto plain tensors
    # and back onto the mesh; checksum and loss on a fixed batch each time
    model, state, mesh, _ = kept
    gen = torch.Generator().manual_seed(SEED + 2)
    batch = {k: torch.randint(0, model.cfg.vocab_size, (B, S),
                              generator=gen) for k in ("inputs", "labels")}
    saved = {"checksum": param_checksum(state["params"]),
             "loss": fixed_loss(model, train.to_device(
                 batch, torch.device("cuda"), mesh))}
    ck = tempfile.mkdtemp(prefix="mesh_ckpt_")
    t0 = time.perf_counter()
    CheckpointManager(ck).save(1, state, data_cursor=1, blocking=True)
    t_save = time.perf_counter() - t0
    shapes = {"params": {k: v.shape for k, v in state["params"].items()}}
    del kept, model, state
    free_card()
    cfg_model = get_model(get_arch(arch), device="cuda")
    t0 = time.perf_counter()
    plain = cfg_model.init(torch.Generator(device="cuda"))
    target = tsteps.train_state(plain, AdamWConfig())
    target, cursor = CheckpointManager(ck).restore(1, target)
    t_plain = time.perf_counter() - t0
    require(cursor == 1, f"mesh (d): cursor {cursor}")
    plain_r = {"checksum": param_checksum(target["params"]),
               "loss": fixed_loss(plain, {k: v.cuda()
                                          for k, v in batch.items()})}
    del plain, target, cfg_model
    free_card()
    model = get_model(get_arch(arch), device="cuda").init(
        torch.Generator(device="cuda"))
    state = tsteps.shard_train_state(model, mesh, AdamWConfig())
    axes = tsteps.train_state_logical_axes(model, True, by_name=True)
    t0 = time.perf_counter()
    restored, cursor = CheckpointManager(ck).restore(
        1, state, shardings=tree_shardings(axes, state, mesh), mesh=mesh)
    with torch.no_grad():
        for k, p in state["params"].items():
            p.to_local().copy_(restored["params"][k].to_local())
    t_mesh = time.perf_counter() - t0
    mesh_r = {"checksum": param_checksum(state["params"]),
              "loss": fixed_loss(model, train.to_device(
                  batch, torch.device("cuda"), mesh))}
    shutil.rmtree(ck, ignore_errors=True)
    tc, tl = MESH_PARITY
    for what, r in (("plain", plain_r), ("mesh", mesh_r)):
        require(abs(r["checksum"] - saved["checksum"])
                <= tc * abs(saved["checksum"])
                and abs(r["loss"] - saved["loss"])
                <= tl * max(abs(saved["loss"]), 1e-8),
                f"mesh (d): restored onto {what} {r} vs saved {saved}")
    row = {"part": "d", "saved": saved, "plain": plain_r, "mesh": mesh_r,
           "save_s": t_save, "restore_plain_s": t_plain,
           "restore_mesh_s": t_mesh, "state_bytes": state_bytes(state)}
    report["mesh"].append(row)
    say("mesh", f"(d) checkpoint of (c)'s sharded state "
                f"({row['state_bytes'] / 1e9:.1f} GB, saved in {t_save:.1f}"
                f" s): restored onto plain tensors ({t_plain:.1f} s) "
                f"checksum {plain_r['checksum']:.6g} loss "
                f"{plain_r['loss']:.6f}, back onto the mesh by "
                f"tree_shardings ({t_mesh:.1f} s) checksum "
                f"{mesh_r['checksum']:.6g} loss {mesh_r['loss']:.6f}, "
                f"saved {saved['checksum']:.6g} / {saved['loss']:.6f} "
                f"(parity bounds {tc:g} / {tl:g} relative); card {card}")
    del model, state, restored
    free_card()
    return shapes["params"]


def mesh_compression_case(report, card, shapes):
    """(e) ``compressed_pod_psum`` over a one-rank "pod" group on bf16
    gradients of (c)'s parameter shapes: equal to a local quantize and
    dequantize, exactly."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compression

    pod = make_mesh((1,), ("pod",))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    grads = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-3).to(
        torch.bfloat16) for k, s in shapes.items()}
    error = {k: torch.zeros(s, device="cuda") for k, s in shapes.items()}
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, err = compression.compressed_pod_psum(grads, error, pod,
                                                stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, g in grads.items():
        q, sc = compression.quantize(g.float() + error[k])
        deq = compression.dequantize(q, sc)
        require(torch.equal(stats["q"][k], q) and torch.equal(mean[k], deq)
                and torch.equal(err[k], g.float() + error[k] - deq),
                f"mesh (e): {k} differs from a local quantize/dequantize")
    n = sum(g.numel() for g in grads.values())
    row = {"part": "e", "tensors": len(grads), "elements": n,
           "wall_s": wall, "wire_bytes_int32": 4 * n}
    report["mesh"].append(row)
    say("mesh", f"(e) compressed_pod_psum over a one-rank 'pod' group on "
                f"{len(grads)} bf16 gradients ({n / 1e9:.3f} B elements): "
                f"== local quantize/dequantize exactly (payloads, means, "
                f"errors), {wall:.2f} s; int32 on the wire ({4 * n / 1e9:.1f}"
                f" GB a reduction); card {card}")


def mesh_seq_decode_case(report, card):
    """(f) sequence-parallel decode through ``layers.local_decode`` on the
    one-rank group: decode caches of llama3.2-3b's widths (:data:`SEQ_CASE`)
    as DTensors on a (1, 1) (data, model) mesh placed (Shard(0), Shard(1)),
    batch rows on "data" and the sequence on "model", as the rules place
    them where the KV heads do not divide the model axis.  So the
    sequence branch runs whole: the rank's slice write and kernel-2
    partial pass, the functional all-gather of its partials over NCCL, the
    combine pass.  Against the same write and the unsplit kernel 2 on
    plain tensors, in bf16 and f32 (:data:`SEQ_TOL`); the ``seq_decode``
    counts are set to 0 just before the two decodes and read just after:
    the launches of this path in the kernels line."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import (SEQ_DECODE_PATH, cache_update,
                                           local_decode)

    mesh = make_mesh((1, 1), ("data", "model"))
    placed = (Shard(0), Shard(1))
    rep = (Replicate(), Replicate())
    B, S, L, hkv, G, d = SEQ_CASE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    wrappers = (kfa.flash_partial, kfa.flash_combine)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        q = rand((B, hkv * G, d), gen, dt)
        kn, vn = (rand((B, hkv, d), gen, dt) for _ in range(2))
        k0, v0 = (rand((B, S, hkv, d), gen, dt) for _ in range(2))
        length = torch.full((B,), L, dtype=torch.int32, device="cuda")
        k_all, v_all = k0.clone(), v0.clone()
        cache_update(k_all, kn, length)
        cache_update(v_all, vn, length)
        saved = tuple(w.launches for w in wrappers)
        want = kfa.flash_decode_attention(q, k_all, v_all, length + 1)
        kfa.flash_partial.launches, kfa.flash_combine.launches = saved
        cases.append((dt, [DTensor.from_local(t, mesh, rep)
                           for t in (q, kn, vn, length)],
                      [DTensor.from_local(t, mesh, placed) for t in (k0, v0)],
                      k_all, v_all, want))
    for w in wrappers:
        w.launches_by_path[SEQ_DECODE_PATH] = 0
    outs = [local_decode(*args, *caches, length)
            for _, (*args, length), caches, *_ in cases]
    torch.cuda.synchronize()
    la = {p: w.launches_by_path[SEQ_DECODE_PATH]
          for p, w in zip(("partial", "combine"), wrappers)}
    rows = []
    for (dt, _, (kc, vc), k_all, v_all, want), out in zip(cases, outs):
        require(isinstance(out, DTensor)
                and tuple(out.placements) == (Shard(0), Replicate()),
                f"mesh (f): {dt}: the decode came back as {type(out)} "
                f"{getattr(out, 'placements', None)}")
        diff = (out.to_local().float() - want.float()).abs()
        atol, rtol = SEQ_TOL[dt]
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        same = (torch.equal(kc.to_local(), k_all)
                and torch.equal(vc.to_local(), v_all))
        require(ok and same, f"mesh (f): {dt}: max err {diff.max().item()} "
                             f"against the unsplit kernel 2 (atol {atol}, "
                             f"rtol {rtol}), caches equal {same}")
        rows.append({"dtype": str(dt)[6:], "max_abs_err": diff.max().item()})
    require(la == {"partial": len(cases), "combine": len(cases)},
            f"mesh (f): kernel 2 launched {la} under {SEQ_DECODE_PATH!r}, "
            f"expected one partial and one combine pass a decode")
    report["launches"][SEQ_DECODE_PATH] = la
    report["mesh"].append({"part": "f", "rows": rows, "launches": la})
    say("mesh", f"(f) local_decode on caches (B={B}, S={S}, Hkv={hkv}, "
                f"d={d}; {L} valid, the new token at {L}) placed "
                f"{placed} on a one-rank (data, model) mesh, q with G={G}: "
                + "; ".join(f"{r['dtype']} max err {r['max_abs_err']:.3g}"
                            for r in rows)
                + f" against the unsplit kernel 2 on plain tensors, caches "
                f"equal to its write; kernel 2 launched under "
                f"{SEQ_DECODE_PATH!r} {json.dumps(la)} in the two decodes "
                f"(slice pass, NCCL all-gather of the partials, combine); "
                f"card {card}")


def phase_mesh(report, card, main_io, bf16_io):
    """Phase 16: the MESH tier and the sharded model zoo on a one-rank
    NCCL group, torn down at the end."""
    from repro_torch.launch.mesh import init_distributed, make_mesh, shutdown

    t0 = time.perf_counter()
    took = {}
    init_distributed("cuda")
    try:
        ring = make_mesh((1,), ("model",))
        A, B, C, host_out, (alpha, beta, _) = main_io
        t1 = time.perf_counter()
        mesh_ring_case(report, card, ring, "a", A, B, C, alpha, beta,
                       host_out, "phase 3's host-tier result (== phase 4's "
                       "and the in-core launch, bitwise)")
        A, B, C, bf_out = bf16_io
        mesh_ring_case(report, card, ring, "a_bf16", A, B, C, alpha, beta,
                       bf_out, "phase 7's bf16 result (== its in-core "
                       "launch)")
        took["ab"] = round(time.perf_counter() - t1, 1)
        del A, B, C, host_out, bf_out
        free_card()
        t1 = time.perf_counter()
        shapes = mesh_train_case(report, card)
        took["cd"] = round(time.perf_counter() - t1, 1)
        t1 = time.perf_counter()
        mesh_compression_case(report, card, shapes)
        took["e"] = round(time.perf_counter() - t1, 1)
        t1 = time.perf_counter()
        mesh_seq_decode_case(report, card)
        took["f"] = round(time.perf_counter() - t1, 1)
    finally:
        shutdown()
        free_card()
    say("mesh", f"phase 16 took {time.perf_counter() - t0:.1f} s (by part "
                f"{json.dumps(took)}); multi-rank rings, gathers and "
                f"reductions run only on the CPU tests' gloo ranks (one "
                f"card here)")


# phase 17 (the dry-run on fake ranks, and sequence-parallel decode)
# (a): 8 KV heads on a model axis of 16, so the caches shard the sequence
DRYRUN_CELL = ("llama3.2-3b", "decode_32k")
DRYRUN_TIMEOUT = 300
# (c): llama3.2-3b's decode widths at phase 14's serving step: B, cache
# positions, valid, Hkv, G, d; the sequence split into these many slices
SEQ_CASE = (4, 544, 528, 8, 3, 128)
SEQ_SPLITS = (2, 4, 8)
# (atol, rtol) against the unsplit kernel 2: f32 to its summation order,
# bf16 to two roundings of the output (2^-7 relative)
SEQ_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-4, 2.0 ** -7)}


def dryrun_cli_case(report, card):
    """(a) ``python -m repro_torch.launch.dryrun`` in a child process on
    llama3.2-3b decode_32k at 16x16: 256 fake ranks, fake tensors on the
    card's device; the caches' 8 KV heads do not divide the model axis of
    16, so every layer decodes sequence-parallel (fault 1's path)."""
    arch, shape = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], capture_output=True,
            text=True, timeout=DRYRUN_TIMEOUT, env=child_env())
        wall = time.perf_counter() - t0
        path = os.path.join(out, f"{arch}__{shape}__single.json")
        require(res.returncode == 0 and os.path.exists(path),
                f"dryrun (a): the CLI failed (rc {res.returncode}): "
                f"{res.stdout[-1000:]} {res.stderr[-3000:]}")
        with open(path) as f:
            art = json.load(f)
    require(art["status"] == "OK", f"dryrun (a): {arch} {shape} is "
                                   f"{art['status']}: {art.get('error')} "
                                   f"{art.get('traceback')}")
    require(art["trace_device"] == "cuda" and art["flops_per_device"] > 0,
            f"dryrun (a): traced on {art['trace_device']} with "
            f"{art['flops_per_device']} flops")
    r = art["roofline"]
    report["dryrun"].append({"part": "a", "wall_s": wall, **art})
    say("dryrun", f"(a) launch.dryrun {arch} {shape} on {art['mesh']} "
                  f"({art['chips']} fake ranks, fake {art['trace_device']} "
                  f"tensors): OK in {art['trace_s']} s of trace "
                  f"({wall:.1f} s with the process); device_hbm_bytes "
                  f"{art['device_hbm_bytes']} "
                  f"({art['device_hbm_bytes'] / 2**30:.2f} GiB, fits "
                  f"{art['fits_hbm']}); {art['n_params']} parameters; "
                  f"per device {art['flops_per_device']:.4g} flops, "
                  f"{art['bytes_per_device']:.4g} bytes, wire bytes by "
                  f"kind {json.dumps(art['collectives'])} (counts "
                  f"{json.dumps(art['collective_counts_scan_body'])}); "
                  f"roofline (H100 SXM data sheet) Tc {r['t_compute_s']:.3g} "
                  f"s, Tm {r['t_memory_s']:.3g} s, Tx "
                  f"{r['t_collective_s']:.3g} s, bound {r['bottleneck']}, "
                  f"frac {r['roofline_fraction']:.3f}, useful "
                  f"{r['useful_flops_ratio']:.2f}; card {card}")


def dryrun_train_case(report, card):
    """(b) phase 15 (b)'s cell traced on a one-rank fake mesh: its flops
    equal to ``FlopCounterMode``'s count of the real step on the card, its
    predicted peak memory and roofline bound beside phase 15's
    measurements."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import steps as tsteps

    arch, B, S, _, _ = TRAIN_MAIN
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    with fake_world(1):
        art = trace_cell(cfg, ShapeConfig("train_phase15b", S, B, "train"),
                         make_mesh((1, 1), ("data", "model")))
    trace_s = time.perf_counter() - t0
    free_card()
    model = get_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    opt = AdamWConfig()
    state = tsteps.train_state(model, opt)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("inputs", "labels")}
    step = tsteps.build_train_step(model, opt)
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    torch.cuda.synchronize()
    real = fc.get_total_flops()
    del model, state, step, batch
    free_card()
    require(art["flops_per_device"] == real,
            f"dryrun (b): the trace's {art['flops_per_device']} flops, the "
            f"real step's {real}")
    measured = next(r for r in report["train"] if r["part"] == "b")
    r = art["roofline"]
    bound_ms = max(r["t_compute_s"], r["t_memory_s"],
                   r["t_collective_s"]) * 1e3
    row = {"part": "b", "arch": arch, "B": B, "S": S, "trace_s": trace_s,
           "flops": art["flops_per_device"], "real_flops": real,
           "bytes": art["bytes_per_device"],
           "predicted_peak_bytes": art["device_hbm_bytes"],
           "measured_peak_bytes": measured["peak_bytes"],
           "bound_ms": bound_ms, "bottleneck": r["bottleneck"],
           "measured_step_ms": measured["step_ms_median"]}
    report["dryrun"].append(row)
    say("dryrun", f"(b) {arch} train B={B} S={S} (phase 15 (b)'s cell) "
                  f"traced on a one-rank fake mesh in {trace_s:.1f} s: "
                  f"{art['flops_per_device']:.6g} flops == FlopCounterMode's "
                  f"{real} of the real step on the card; predicted peak "
                  f"{art['device_hbm_bytes'] / 1e9:.2f} GB against phase 15's "
                  f"measured max_memory_allocated "
                  f"{measured['peak_bytes'] / 1e9:.2f} GB; roofline bound "
                  f"{bound_ms:.2f} ms ({r['bottleneck']}; Tc "
                  f"{r['t_compute_s'] * 1e3:.2f} ms, Tm "
                  f"{r['t_memory_s'] * 1e3:.2f} ms of "
                  f"{art['bytes_per_device'] / 1e9:.1f} GB moved op by op) "
                  f"against the measured step {measured['step_ms_median']:.2f}"
                  f" ms; card {card}")


def seq_decode_case(report, card, gen):
    """(c) fault 1's sequence-parallel decode on the card: one cache of
    llama3.2-3b's decode widths split into 2, 4 and 8 slices, each slice's
    write and kernel-2 partial pass (``layers.seq_slice_partials``), their
    partials in slice order folded by the combine pass
    (``layers.seq_combine``), against the same write and the unsplit
    kernel 2; in f32 and bf16."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.layers import (SEQ_DECODE_PATH, cache_update,
                                           seq_combine, seq_slice_partials)

    B, S, L, hkv, G, d = SEQ_CASE
    wrappers = (kfa.flash_partial, kfa.flash_combine)
    kept = [w.launches_by_path.pop(SEQ_DECODE_PATH, 0) for w in wrappers]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        q = rand((B, hkv * G, d), gen, dt)
        kn, vn = (rand((B, hkv, d), gen, dt) for _ in range(2))
        k0, v0 = (rand((B, S, hkv, d), gen, dt) for _ in range(2))
        length = torch.full((B,), L, dtype=torch.int32, device="cuda")
        k_all, v_all = k0.clone(), v0.clone()
        cache_update(k_all, kn, length)
        cache_update(v_all, vn, length)
        saved = tuple(w.launches for w in wrappers)
        want = kfa.flash_decode_attention(q, k_all, v_all, length + 1)
        kfa.flash_partial.launches, kfa.flash_combine.launches = saved
        for W in SEQ_SPLITS:
            n = S // W
            ks, vs = k0.clone(), v0.clone()
            parts = [seq_slice_partials(q, kn, vn, ks[:, r * n:(r + 1) * n],
                                        vs[:, r * n:(r + 1) * n], length, r)
                     for r in range(W)]
            out = seq_combine((torch.cat([p[0] for p in parts], -1),
                               torch.cat([p[1] for p in parts], -1),
                               torch.cat([p[2] for p in parts], -2)),
                              q.dtype)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            err = diff.max().item()
            atol, rtol = SEQ_TOL[dt]
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            require(ok and torch.equal(ks, k_all) and torch.equal(vs, v_all),
                    f"dryrun (c): {W} slices {dt}: max err {err} against "
                    f"the unsplit kernel 2 (atol {atol}, rtol {rtol}), "
                    f"caches equal {torch.equal(ks, k_all)} "
                    f"{torch.equal(vs, v_all)}")
            rows.append({"dtype": str(dt)[6:], "slices": W,
                         "slice_positions": n, "max_abs_err": err})
        del q, kn, vn, k0, v0, k_all, v_all, ks, vs, want, out
    la = {p: w.launches_by_path.get(SEQ_DECODE_PATH, 0)
          for p, w in zip(("partial", "combine"), wrappers)}
    for w, n in zip(wrappers, kept):
        w.launches_by_path[SEQ_DECODE_PATH] = n
    report["dryrun"].append({"part": "c", "rows": rows, "launches": la})
    say("dryrun", f"(c) sequence-parallel decode, B={B} S={S} ({L} valid, "
                  f"the new token written at {L}), Hkv={hkv} G={G} d={d}: "
                  + "; ".join(f"{r['dtype']} {r['slices']} slices of "
                              f"{r['slice_positions']}: max err "
                              f"{r['max_abs_err']:.3g}" for r in rows)
                  + f" against the unsplit kernel 2 ((atol, rtol) "
                  f"{SEQ_TOL[torch.float32]} f32, {SEQ_TOL[torch.bfloat16]} "
                  f"bf16), caches equal to the unsplit write; kernel 2 "
                  f"launched {json.dumps(la)} (phase 16 (f) holds the "
                  f"path's count); card {card}")


def phase_dryrun(report, card, gen):
    """Phase 17: the dry-run on fake ranks (a, b) and the sequence-parallel
    decode's kernel-2 passes on the card (c)."""
    from repro_torch.distributed.cost_analysis import HBM_BYTES

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    say("dryrun", f"total_memory {total} B; the dry-run's HBM_BYTES "
                  f"{HBM_BYTES}")
    require(total == HBM_BYTES, f"dryrun: the card's total_memory {total} "
                                f"!= cost_analysis.HBM_BYTES {HBM_BYTES}")
    took = {}
    for name, run in (("a", lambda: dryrun_cli_case(report, card)),
                      ("b", lambda: dryrun_train_case(report, card)),
                      ("c", lambda: seq_decode_case(report, card, gen))):
        t1 = time.perf_counter()
        run()
        took[name] = round(time.perf_counter() - t1, 1)
    free_card()
    say("dryrun", f"phase 17 took {time.perf_counter() - t0:.1f} s (by part "
                  f"{json.dumps(took)})")


# ---------------------------------------------------------------------------
# Phase 18: the paper's claims C2, C3 and C5, and its reuse claim, on the
# card ([claims] lines)
# ---------------------------------------------------------------------------
CLAIMS_K = 8192
CLAIMS_SIZES = (8192, 12288, 16384, 24576)     # M = N; 8192 is in core
# 3 x 8192^2 elements of the dtype: the 8192 problem just fits, 12288 not
CLAIMS_BUDGET = {torch.float32: 768 * 2**20, torch.bfloat16: 384 * 2**20}
CLAIMS_C3 = 16384          # M = N of (b) and (c)
CLAIMS_TILE = 512          # the vendor schedule's C tile
CLAIMS_C5 = ((1, 1), (1, 2), (2, 2), (2, 4))   # (nstreams, nbuf)
CLAIMS_REPS = 3            # timed calls after one warm call; medians kept
# (b)'s executor modes by dtype; bf16 in one mode, so the phase stays short
CLAIMS_C3_MODES = {torch.float32: ("concurrent", "issue_order"),
                   torch.bfloat16: ("concurrent",)}
CLAIMS_AB = (1.5, 0.5)     # alpha, beta
CLAIMS_COPY = (16384, 8192, 2048, 256 * 2**20)  # (d): rows, cols, bm, budget
CLAIMS_SLACK = 64 * 2**20  # allocator rounding, as phase 3
CLAIMS_SEARCH = 256        # the tuner's max_steps (the hybrid tests' knob)


def span_stats(sched, spans, wall):
    """(device idle share of ``wall``, kernel-1 device seconds) from an
    executor's recorded spans (every compute op of a GEMM schedule is one
    kernel-1 launch)."""
    from repro_torch.core import OpKind

    k1 = sum(s[3] - s[2] for op, s in zip(sched.ops, spans)
             if op.kind == OpKind.COMPUTE)
    return member_busy(spans, wall)[1], k1


def claims_calls(tag, fn, want, launches, limit, ex=None, sched=None,
                 warm=True):
    """One warm call of ``fn`` (none without ``warm``) and
    ``CLAIMS_REPS`` timed ones.  Every call's result must equal ``want``
    bit for bit, launch kernel 1
    ``launches`` times, keep peak device memory within ``limit`` and, on
    an executor ``ex`` running ``sched``, move ``schedule_stats``' bytes.
    Returns the medians of the timed calls: the call's wall (host clock
    around it), and on an executor its wall, host staging fill and wait,
    the device idle share and kernel 1's device seconds from the spans."""
    from repro_torch.core import schedule_stats
    from repro_torch.kernels.block_matmul import block_matmul

    stats = schedule_stats(sched) if sched is not None else None
    rows = []
    peak_max = 0
    for rep in range(int(warm) + CLAIMS_REPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = block_matmul.launches
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        got = block_matmul.launches - before
        peak = torch.cuda.max_memory_allocated() - base
        peak_max = max(peak_max, peak)
        require(got == launches, f"claims {tag}: {got} kernel-1 launches, "
                                 f"expected {launches}")
        require(torch.equal(out, want), f"claims {tag}: the result differs "
                                        f"from one in-core launch")
        require(peak <= limit, f"claims {tag}: peak device memory {peak} B "
                               f"above {limit} B")
        del out
        if ex is not None:
            require((ex.last_h2d_bytes, ex.last_d2h_bytes)
                    == (stats["h2d_bytes"], stats["d2h_bytes"]),
                    f"claims {tag}: moved {ex.last_h2d_bytes}/"
                    f"{ex.last_d2h_bytes} B, schedule_stats says "
                    f"{stats['h2d_bytes']}/{stats['d2h_bytes']}")
        if warm and rep == 0:
            continue
        row = {"call_s": wall}
        if ex is not None:
            idle, k1 = span_stats(sched, ex.last_spans, ex.last_wall_seconds)
            row.update(exec_s=ex.last_wall_seconds,
                       stage_s=ex.last_stage_seconds,
                       stage_wait_s=ex.last_stage_wait_seconds,
                       idle_share=idle, k1_device_s=k1)
        rows.append(row)
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    med["call_s_min"] = min(r["call_s"] for r in rows)
    med["call_s_max"] = max(r["call_s"] for r in rows)
    med["peak_bytes"] = peak_max
    med["launches"] = launches
    if stats is not None:
        med["h2d_bytes"], med["d2h_bytes"] = (stats["h2d_bytes"],
                                              stats["d2h_bytes"])
    return med


def claims_text(m, flops):
    """One measured call's line: walls, TFLOP/s, staging, idle share,
    kernel 1's launches and device time, bytes and peak memory."""
    text = (f"call {m['call_s']:.4f} s (min-max {m['call_s_min']:.4f}-"
            f"{m['call_s_max']:.4f}), {flops / m['call_s'] / 1e12:.2f} "
            f"TFLOP/s; ")
    if "exec_s" in m:
        text += (f"executor {m['exec_s']:.4f} s, staging fill "
                 f"{m['stage_s']:.4f} s and wait {m['stage_wait_s']:.4f} s, "
                 f"device idle {100 * m['idle_share']:.1f} %, kernel 1 "
                 f"{m['launches']} launches, {m['k1_device_s']:.4f} s on the "
                 f"device; H2D {m['h2d_bytes']} B, D2H {m['d2h_bytes']} B = "
                 f"schedule_stats; ")
    else:
        text += f"kernel 1 {m['launches']} launch; "
    return text + f"peak {m['peak_bytes'] / 2**20:.1f} MiB"


def claims_operands(full, n, dt):
    """Host operands of the n x n x CLAIMS_K problem in ``dt``: the leading
    rows and columns of the largest problem's."""
    A, B, C = full
    return (A[:n].to(dt), B[:, :n].contiguous().to(dt),
            C[:n, :n].contiguous().to(dt))


def claims_in_core(tag, A, B, C, report, key):
    """One in-core launch of kernel 1 on the whole problem through
    ``ooc_gemm`` (counted under ``key``): the bit-for-bit reference of
    every out-of-core result of the same operands.  It is first held to
    a float32 ``torch.addmm`` on the card within two float32 summation
    bounds (kernel 1's sum and addmm's), plus the rounding of a 16-bit
    output."""
    from repro_torch.core import ooc_gemm
    from repro_torch.kernels.block_matmul import block_matmul

    zero_counts(block_matmul)
    want = ooc_gemm(A, B, C, *CLAIMS_AB, budget_bytes=1 << 40)
    require(read_counts(block_matmul, report, key, add=True) == 1,
            f"claims {tag}: the in-core call is not one launch")
    alpha, beta = CLAIMS_AB
    Ad, Bd, Cd = (t.cuda().float() for t in (A, B, C))
    ref = torch.addmm(Cd, Ad, Bd, beta=beta, alpha=alpha)
    bound = 2 * sum_tol(Ad, Bd, Cd, alpha, beta)
    del Ad, Bd, Cd
    u_out = 0.0 if want.dtype == torch.float32 else 2.0 ** -8
    tol = bound + u_out * (ref.abs().double() + bound)
    err = (want.cuda().double() - ref.double()).abs()
    worst = (err / tol).max().item()
    require(worst <= 1.0, f"claims {tag}: the in-core launch is "
                          f"{err.max().item():.4g} from float32 addmm, "
                          f"{worst:.3g}x its bound")
    report["claims"].append({"part": "oracle", "tag": tag,
                             "max_abs_err": err.max().item(),
                             "err_over_bound": worst})
    say("claims", f"{tag}: one in-core launch vs float32 torch.addmm on the "
                  f"card: max abs err {err.max().item():.4g} beside max "
                  f"|ref| {ref.abs().max().item():.4g}, max err/bound "
                  f"{worst:.3g} (bound 2 sqrt(K) u32 sum|terms|"
                  + (" + 2^-8 |ref|)" if u_out else ")"))
    del ref, bound, tol, err
    return want


def claims_c2(report, full, dt):
    """(a) The in-core to out-of-core transition: ``ooc_gemm`` at K 8192
    under the budget, M = N from in core (8192) to 3x out (24576), in
    ``concurrent`` and ``issue_order`` mode.  Returns the in-core result
    at M = N = ``CLAIMS_C3``."""
    from repro_torch.core import (HostOocRuntime, ScheduleExecutor,
                                  build_gemm_schedule, is_in_core, ooc_gemm,
                                  plan_gemm_partition)
    from repro_torch.kernels.block_matmul import block_matmul

    name = str(dt)[6:]
    budget = CLAIMS_BUDGET[dt]
    K = CLAIMS_K
    tf = {}
    keep = None
    for n in CLAIMS_SIZES:
        A, B, C = claims_operands(full, n, dt)
        bpe = A.element_size()
        flops = 2 * n * n * K
        want = claims_in_core(f"c2 {n} {name}", A, B, C, report,
                              "claims_in_core")
        if n == CLAIMS_C3:
            keep = want
        zero_counts(block_matmul)
        if is_in_core(n, n, K, budget, bpe):
            nbytes = (2 * n * K + n * n) * bpe
            m = claims_calls(f"c2 {n} {name} in core",
                             lambda: ooc_gemm(A, B, C, *CLAIMS_AB,
                                              budget_bytes=budget),
                             want, 1, nbytes + n * n * bpe + CLAIMS_SLACK)
            tf[(n, "in core")] = flops / m["call_s"]
            report["claims"].append({"part": "c2", "dtype": name, "n": n,
                                     "mode": "in core", "budget": budget,
                                     **m})
            say("claims", f"(a) {name} {n}x{n}x{K} in core ({nbytes} B of "
                          f"operands within the {budget} B budget; one "
                          f"launch, serial pageable copies in its wall): "
                          f"{claims_text(m, flops)} (A, B, C and the "
                          f"output: the output is beyond the budget)")
        else:
            part = plan_gemm_partition(n, n, K, budget, bpe)
            sched = build_gemm_schedule(part, nstreams=2, nbuf=2)
            ws = part.working_set_bytes(nbuf=2, nstreams=2)
            for mode in ("concurrent", "issue_order"):
                ex = ScheduleExecutor(mode=mode, record_spans=True)
                rt = HostOocRuntime(executor=ex)
                m = claims_calls(
                    f"c2 {n} {name} {mode}",
                    lambda: ooc_gemm(A, B, C, *CLAIMS_AB,
                                     budget_bytes=budget, runtime=rt),
                    want, dgemm_ops(sched), ws + CLAIMS_SLACK, ex, sched)
                tf[(n, mode)] = flops / m["call_s"]
                report["claims"].append({
                    "part": "c2", "dtype": name, "n": n, "mode": mode,
                    "plan": [part.h, part.w], "working_set": ws,
                    "budget": budget, **m})
                say("claims", f"(a) {name} {n}x{n}x{K} {mode}, plan "
                              f"{part.h}x{part.w} of {part.bm}x{part.bn}, "
                              f"2 streams 2 buffers: {claims_text(m, flops)}"
                              f" <= working set {ws / 2**20:.1f} MiB + 64 "
                              f"MiB (budget {budget / 2**20:.0f} MiB); == "
                              f"one in-core launch, bitwise")
        read_counts(block_matmul, report, "claims_c2", add=True)
        del A, B, C, want
    last_in = tf[(CLAIMS_SIZES[0], "in core")]
    for mode in ("concurrent", "issue_order"):
        curve = [last_in] + [tf[(n, mode)] for n in CLAIMS_SIZES[1:]]
        change = (curve[1] - last_in) / last_in
        report["claims"].append({"part": "c2 claim", "dtype": name,
                                 "mode": mode, "change": change,
                                 "tflops": [t / 1e12 for t in curve]})
        say("claims", f"(a) C2 {name} {mode}: first out-of-core "
                      f"({CLAIMS_SIZES[1]}) {curve[1] / 1e12:.2f} TFLOP/s "
                      f"against the last in-core ({CLAIMS_SIZES[0]}) "
                      f"{last_in / 1e12:.2f}: {100 * change:+.1f} % (the "
                      f"paper: 0 %; no loss at -10 %: "
                      f"{'held' if change >= -0.10 else 'missed'}; the "
                      f"in-core side's wall is its serial pageable copies, "
                      f"so a gain measures that path, not the transition); "
                      f"TFLOP/s by M = N "
                      + ", ".join(f"{n} {t / 1e12:.2f}"
                                  for n, t in zip(CLAIMS_SIZES, curve)))
    return keep


def wrapper_host_us(A, B, C, n=200):
    """Host microseconds of kernel 1's library lookup
    (``_build.load``) and of one whole wrapper call on a vendor tile,
    enqueued behind a spin kernel so the card never holds the host.  The
    callers set kernel 1's counts to 0 after it, so these launches count
    on no path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_matmul import block_matmul

    t0 = time.perf_counter()
    for _ in range(5 * n):
        _build.load("block_matmul")
    load_us = (time.perf_counter() - t0) / (5 * n) * 1e6
    a, b = A[:CLAIMS_TILE].cuda(), B[:, :CLAIMS_TILE].contiguous().cuda()
    c = C[:CLAIMS_TILE, :CLAIMS_TILE].cuda()
    block_matmul(a, b, c, alpha=1.0, beta=1.0, out=c)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(n):
        block_matmul(a, b, c, alpha=1.0, beta=1.0, out=c)
    call_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return load_us, call_us


def claims_c3(report, full, dt, want):
    """(b) ``ooc_gemm``'s own plan against the CUBLAS-XT-style vendor
    schedule (tile 512: one stream, one buffer, B re-sent for every C
    tile) on the same executor class and ``dgemm`` handler."""
    from repro_torch.core import (HostOocRuntime, ScheduleExecutor,
                                  build_gemm_schedule, build_vendor_schedule,
                                  ooc_gemm, plan_gemm_partition,
                                  schedule_stats)
    from repro_torch.kernels.block_matmul import block_matmul

    name = str(dt)[6:]
    budget = CLAIMS_BUDGET[dt]
    n, K = CLAIMS_C3, CLAIMS_K
    A, B, C = claims_operands(full, n, dt)
    part = plan_gemm_partition(n, n, K, budget, A.element_size())
    lib = build_gemm_schedule(part, nstreams=2, nbuf=2)
    vend = build_vendor_schedule(part, tile=CLAIMS_TILE)
    flops = 2 * n * n * K
    load_us, call_us = wrapper_host_us(A, B, C)
    say("claims", f"(b) {name} kernel 1's wrapper: {load_us:.1f} us of "
                  f"library lookup (_build.load) and {call_us:.1f} us of "
                  f"host a call on a {CLAIMS_TILE}x{CLAIMS_TILE}x{K} tile: "
                  f"{dgemm_ops(vend)} vendor launches carry "
                  f"{dgemm_ops(vend) * call_us / 1e6:.3f} s of host, "
                  f"{dgemm_ops(lib)} library launches "
                  f"{dgemm_ops(lib) * call_us / 1e6:.4f} s")
    # the vendor side takes no warm call: kernel 1 is warm from the
    # phases before, and its executor's set-up is small beside a 3-5 s call
    sides = (("library", "claims_c3_library", lib,
              part.working_set_bytes(nbuf=2, nstreams=2), True,
              lambda rt: ooc_gemm(A, B, C, *CLAIMS_AB, budget_bytes=budget,
                                  runtime=rt)),
             ("vendor", "claims_c3_vendor", vend, parity_bytes(vend), False,
              lambda rt: rt.gemm(A, B, C, *CLAIMS_AB, part, schedule=vend)))
    got = {}
    for mode in CLAIMS_C3_MODES[dt]:
        for side, key, sched, ws, warm, call in sides:
            ex = ScheduleExecutor(mode=mode, record_spans=True)
            rt = HostOocRuntime(executor=ex)
            zero_counts(block_matmul)
            m = claims_calls(f"c3 {name} {side} {mode}", lambda: call(rt),
                             want, dgemm_ops(sched), ws + CLAIMS_SLACK, ex,
                             sched, warm)
            read_counts(block_matmul, report, key, add=True)
            got[(side, mode)] = m
            report["claims"].append({
                "part": "c3", "dtype": name, "side": side, "mode": mode,
                "n_ops": schedule_stats(sched)["n_ops"], "parity": ws,
                "wrapper_us": call_us, "lookup_us": load_us, **m})
            say("claims", f"(b) {name} {n}x{n}x{K} {side} {mode} "
                          f"({schedule_stats(sched)['n_ops']} ops): "
                          f"{claims_text(m, flops)} <= parity "
                          f"{ws / 2**20:.1f} MiB + 64 MiB; == one in-core "
                          f"launch, bitwise")
        lib_m, ven_m = got[("library", mode)], got[("vendor", mode)]
        ratio = ven_m["call_s"] / lib_m["call_s"]
        k1 = ven_m["k1_device_s"] / lib_m["k1_device_s"]
        report["claims"].append({"part": "c3 claim", "dtype": name,
                                 "mode": mode, "ratio": ratio,
                                 "k1_ratio": k1})
        say("claims", f"(b) C3 {name} {mode}: vendor / library "
                      f"{ratio:.2f}x (the paper: >= 2.3x on the K40c; "
                      f"{'held' if ratio >= 2.3 else 'missed'}); kernel 1's "
                      f"device seconds {ven_m['k1_device_s']:.4f} / "
                      f"{lib_m['k1_device_s']:.4f} = {k1:.2f}x; the vendor "
                      f"call net of its staging fill "
                      f"{ven_m['call_s'] - ven_m['stage_s']:.4f} s")
    del A, B, C


def claims_c5(report, full, want, profile):
    """(c) Streams and buffers: (b)'s f32 call through ``ooc_gemm(nstreams=,
    nbuf=)`` in ``concurrent`` mode, each beside the simulator's makespan
    of its schedule on the card's calibrated profile; then the stream
    count and buffer depth the tuner picks for the call."""
    from repro_torch.core import (HostOocRuntime, ScheduleExecutor,
                                  build_gemm_schedule, ooc_gemm,
                                  plan_gemm_partition, simulate)
    from repro_torch.kernels.block_matmul import block_matmul
    from repro_torch.tune import AutoTuner, PlanCache

    dt = torch.float32
    budget = CLAIMS_BUDGET[dt]
    n, K = CLAIMS_C3, CLAIMS_K
    A, B, C = claims_operands(full, n, dt)
    part = plan_gemm_partition(n, n, K, budget, 4)
    flops = 2 * n * n * K
    walls = {}
    for ns, nb in CLAIMS_C5:
        sched = build_gemm_schedule(part, nstreams=ns, nbuf=nb)
        sim = simulate(sched, profile.model_for(ns)).makespan
        ws = part.working_set_bytes(nbuf=nb, nstreams=ns)
        ex = ScheduleExecutor(mode="concurrent", record_spans=True)
        rt = HostOocRuntime(executor=ex)
        zero_counts(block_matmul)
        m = claims_calls(f"c5 ({ns},{nb})",
                         lambda: ooc_gemm(A, B, C, *CLAIMS_AB,
                                          budget_bytes=budget, nstreams=ns,
                                          nbuf=nb, runtime=rt),
                         want, dgemm_ops(sched), ws + CLAIMS_SLACK, ex, sched)
        read_counts(block_matmul, report, "claims_c5", add=True)
        walls[(ns, nb)] = m
        report["claims"].append({"part": "c5", "nstreams": ns, "nbuf": nb,
                                 "simulated_s": sim, "working_set": ws,
                                 "budget": budget, **m})
        say("claims", f"(c) f32 {n}x{n}x{K} nstreams {ns} nbuf {nb} "
                      f"concurrent: {claims_text(m, flops)} <= working set "
                      f"{ws / 2**20:.1f} MiB + 64 MiB (budget "
                      f"{budget / 2**20:.0f} MiB: "
                      f"{'within' if m['peak_bytes'] <= budget else 'above'}"
                      f"); simulated {sim:.4f} s on the calibrated profile "
                      f"(executor / simulated "
                      f"{m['exec_s'] / sim:.2f}); == one in-core launch, "
                      f"bitwise")
    best = min(walls, key=lambda k: walls[k]["call_s"])
    # the claim at equal buffers and bytes: two streams win only if their
    # slowest call beats one stream's fastest
    one, two = walls[(1, 2)], walls[(2, 2)]
    held = two["call_s_max"] < one["call_s_min"]
    tmp = tempfile.TemporaryDirectory()
    try:
        tuner = AutoTuner(profile=profile, max_steps=CLAIMS_SEARCH,
                          cache=PlanCache(os.path.join(tmp.name, "p.json")))
        t0 = time.perf_counter()
        plan = tuner.gemm_plan(n, n, K, budget, "float32")
        secs = time.perf_counter() - t0
        tpart = plan.gemm_partition()
        sched = build_gemm_schedule(tpart, nstreams=plan.nstreams,
                                    nbuf=plan.nbuf, traversal=plan.traversal,
                                    evict=plan.evict)
        ws = tpart.working_set_bytes(nbuf=plan.nbuf, nstreams=plan.nstreams)
        ex = ScheduleExecutor(mode="concurrent", record_spans=True)
        rt = HostOocRuntime(executor=ex)
        zero_counts(block_matmul)
        m = claims_calls("c5 tuned",
                         lambda: ooc_gemm(A, B, C, *CLAIMS_AB,
                                          budget_bytes=budget, tune="auto",
                                          tuner=tuner, runtime=rt),
                         want, dgemm_ops(sched), ws + CLAIMS_SLACK, ex, sched)
        read_counts(block_matmul, report, "claims_c5", add=True)
    finally:
        tmp.cleanup()
    report["claims"].append({"part": "c5 claim", "best": list(best),
                             "one_stream_s": one["call_s"],
                             "two_streams_s": two["call_s"], "held": held,
                             "tuned": [plan.nstreams, plan.nbuf],
                             "tuned_plan": [tpart.h, tpart.w],
                             "tuned_makespan": plan.makespan,
                             "search_s": secs, "tuned_run": m})
    say("claims", f"(c) C5 at equal buffers and bytes: one stream (1, 2) "
                  f"{one['call_s']:.4f} s ({one['call_s_min']:.4f}-"
                  f"{one['call_s_max']:.4f}) against two (2, 2) "
                  f"{two['call_s']:.4f} s ({two['call_s_min']:.4f}-"
                  f"{two['call_s_max']:.4f}) (the paper: a GPU prefers two; "
                  f"{'held' if held else 'missed'}: held only if every call "
                  f"of two beats every call of one); fastest of the four "
                  f"{best} at {walls[best]['call_s']:.4f} s, "
                  f"{walls[best]['h2d_bytes']} B H2D against (2, 2)'s "
                  f"{two['h2d_bytes']}; tune='auto' (calibrated profile, max_steps "
                  f"{CLAIMS_SEARCH}, {secs:.1f} s of search) picks "
                  f"{plan_text(plan)}, predicted {plan.makespan:.4f} s; run: "
                  f"{claims_text(m, flops)} <= working set "
                  f"{ws / 2**20:.1f} MiB + 64 MiB (executor / predicted "
                  f"{m['exec_s'] / plan.makespan:.2f}); == one in-core "
                  f"launch, bitwise")
    del A, B, C


def claims_reuse(report, gen):
    """(d) The reuse claim: a scaled block copy written as a
    ``PipelineSpec`` and one registered handler (a PyTorch multiply on
    the card, into its output buffer), on a card-sized operand in both
    modes: exactly ``3.0 * X``, bytes equal to ``schedule_stats``, no
    kernel-1 launch."""
    from repro_torch.core import (ComputeStage, PipelineSpec,
                                  ScheduleExecutor, SliceRef, StreamedOperand,
                                  WriteBack, compile_pipeline,
                                  register_op_handler, schedule_stats,
                                  validate_schedule)
    from repro_torch.kernels.block_matmul import block_matmul

    M, N, bm, budget = CLAIMS_COPY
    h = M // bm

    @register_op_handler("scale_copy")
    def _scale_copy(st, op, ref):
        torch.mul(st.bufs[op.buffers_read[0]], st.ctx["gamma"],
                  out=st.bufs[op.buffers_written[0]])

    def operand(name, inout=False):
        return StreamedOperand(
            name=name, nblocks=h, block_of=lambda s: s,
            slice_of=lambda b: SliceRef(name, b, rows=(b * bm, bm)),
            bytes_of=lambda b: bm * N * 4, inout=inout)

    spec = PipelineSpec(
        name="scale_copy", nsteps=h, operands=(operand("X"),
                                               operand("Y", True)),
        compute=ComputeStage(kernel="scale_copy", reads=("X",),
                             flops_of=lambda s: bm * N),
        writeback=WriteBack(mode="each", operand="Y"), budget=budget)
    sched = compile_pipeline(spec, nstreams=2, nbuf=2)
    validate_schedule(sched)
    stats = schedule_stats(sched)
    parity = parity_bytes(sched)
    require(parity <= budget, f"claims (d): parity {parity} B above the "
                              f"budget {budget} B")
    X = rand((M, N), gen, device="cpu")
    want = X * 3.0
    for mode in ("issue_order", "concurrent"):
        ex = ScheduleExecutor(mode=mode, record_spans=True)
        zero_counts(block_matmul)

        def call():
            out = torch.zeros_like(X)
            ex.run(sched, {"X": X}, {"Y": out}, {"gamma": 3.0})
            return out

        m = claims_calls(f"(d) {mode}", call, want, 0,
                         parity + CLAIMS_SLACK, ex, sched)
        report["claims"].append({"part": "reuse", "mode": mode,
                                 "n_ops": stats["n_ops"], "parity": parity,
                                 **m})
        say("claims", f"(d) scale_copy spec {M}x{N} f32 under "
                      f"{budget / 2**20:.0f} MiB ({h} blocks of {bm} rows, "
                      f"2 streams 2 buffers, {stats['n_ops']} ops) {mode}: "
                      f"call {m['call_s']:.4f} s (min-max "
                      f"{m['call_s_min']:.4f}-{m['call_s_max']:.4f}), "
                      f"executor {m['exec_s']:.4f} s, staging fill "
                      f"{m['stage_s']:.4f} s, device idle "
                      f"{100 * m['idle_share']:.1f} %, H2D "
                      f"{m['h2d_bytes']} B, D2H {m['d2h_bytes']} B = "
                      f"schedule_stats, peak {m['peak_bytes'] / 2**20:.1f} "
                      f"MiB <= parity {parity / 2**20:.1f} MiB + 64 MiB; "
                      f"== 3.0 * X exactly, no kernel-1 launch")
    del X, want


def phase_claims(report, card, gen, profile):
    """Phase 18: the paper's claims on the card, (a)-(d); ``profile`` is
    phase 11's calibrated one.  A claim that the card does not bear out
    is printed as missed; a wrong result, byte count or launch count
    raises."""
    t0 = time.perf_counter()
    M, K = CLAIMS_SIZES[-1], CLAIMS_K
    full = tuple(rand(s, gen, device="cpu")
                 for s in ((M, K), (K, M), (M, M)))
    say("claims", f"host operands {M}x{K}, {K}x{M}, {M}x{M} f32 made on "
                  f"the card from seed {SEED} in "
                  f"{time.perf_counter() - t0:.1f} s; each size takes their "
                  f"leading rows and columns; card {card}")
    took = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        t1 = time.perf_counter()
        want = claims_c2(report, full, dt)
        took[f"a {name}"] = round(time.perf_counter() - t1, 1)
        t1 = time.perf_counter()
        claims_c3(report, full, dt, want)
        took[f"b {name}"] = round(time.perf_counter() - t1, 1)
        if dt == torch.float32:
            t1 = time.perf_counter()
            claims_c5(report, full, want, profile)
            took["c"] = round(time.perf_counter() - t1, 1)
        del want
    del full
    t1 = time.perf_counter()
    claims_reuse(report, gen)
    took["d"] = round(time.perf_counter() - t1, 1)
    free_card()
    say("claims", f"phase 18 took {time.perf_counter() - t0:.1f} s (by "
                  f"part {json.dumps(took)})")


SERVE_TURN = ("llama3.2-3b", 4, 512, 32)     # phase 14 (c)'s serving cell
# the base tree's and this tree's serving processes: ten pairs in ABBA
# blocks, so each side runs first in half of them; each process times
# SERVE_REPS generate calls after an untimed one
SERVE_ORDER = ("base", "this", "this", "base") * 5
SERVE_REPS = 3
# one process serving SERVE_TURN from the tree on its PYTHONPATH as
# launch/serve.main does (random weights and prompts from seed 0): one
# untimed generate (it builds the tree's kernel 2), SERVE_REPS timed ones
# (decode tok/s), then PROFILE_STEPS decode steps under torch.profiler
# (device ops a step)
SERVE_CHILD = r"""
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_arch
from repro_torch.launch.serve import generate
from repro_torch.models import get_model

arch, (B, P, gen, reps, steps) = sys.argv[1], map(int, sys.argv[2:7])
cfg = get_arch(arch)
rng = torch.Generator(device="cuda").manual_seed(0)
model = get_model(cfg, device="cuda").init(rng)
prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=rng,
                        device="cuda")
generate(model, prompts, gen)
tok_s = [B * (gen - 1) / generate(model, prompts, gen)["decode_s"]
         for _ in range(reps)]
logits, cache = model.prefill(prompts, max_len=P + gen)
tok = logits.argmax(-1)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(steps):
        logits, cache = model.decode(cache, tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
ops = sum(1 for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA)
print(json.dumps({"tok_s": tok_s, "device_ops_per_step": ops / steps}))
"""


def serve_child(tree):
    """:data:`SERVE_CHILD` on :data:`SERVE_TURN` from ``tree``'s sources
    in a process of its own: its decode tok/s and device ops a step."""
    arch, B, P, gen = SERVE_TURN
    res = subprocess.run(
        [sys.executable, "-c", SERVE_CHILD, arch, str(B), str(P), str(gen),
         str(SERVE_REPS), str(PROFILE_STEPS)], capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(tree, "src")})
    require(res.returncode == 0, f"base serve: {tree} failed (rc "
                                 f"{res.returncode}): {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def library_dispatch_us(n=500, rounds=5):
    """Host time (us) of one call of kernel 2's passes at llama3.2-3b's
    decode step (:data:`SEQ_CASE`, bf16 caches), by layer of the call:
    ``op`` through the ``torch.library`` operator, as the model calls it;
    ``impl`` the operator's CUDA implementation called directly (the
    wrapper's Python, ``_lib()`` and the launch); ``lib`` the ``_lib()``
    lookup alone; ``launch`` the C launch function through ctypes on
    arguments made once.  ``n`` calls back to back a round (fewer than the
    launch queue holds), all in turns for ``rounds`` rounds; medians.  The
    launch counts are restored after."""
    from repro_torch.kernels import flash_attention as kfa

    B, S, L, hkv, G, d = SEQ_CASE
    H = hkv * G
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qf = rand((B, H, d), gen)
    k, v = (rand((B, S, hkv, d), gen, torch.bfloat16) for _ in range(2))
    lens = torch.full((B,), L + 1, dtype=torch.int32, device="cuda")
    m, l, acc = kfa.empty_partials(B, H, kfa.nsplits(S, 512), d, "cuda")
    out = torch.empty((B, H, d), dtype=torch.bfloat16, device="cuda")
    lib, ops = kfa._lib(), torch.ops.repro_torch
    stream = torch.cuda.current_stream().cuda_stream
    pargs = (kfa._DTYPE_CODE[k.dtype], int(kfa._vector_ok(k, v)),
             qf.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), 0,
             m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, S, hkv, G, d,
             512, m.shape[-1], *k.stride()[:3], *v.stride()[:3],
             1.0 / math.sqrt(d), stream)
    cargs = (kfa._DTYPE_CODE[out.dtype], m.data_ptr(), l.data_ptr(),
             acc.data_ptr(), m.shape[-1], None, None, None, out.data_ptr(),
             out.stride(0), out.stride(1), B, H, d, 1, stream)
    calls = {
        "partial_op": lambda: ops.flash_partial(qf, k, v, lens, 0, m, l,
                                                acc, 512, ""),
        "partial_impl": lambda: kfa._partial_cuda(qf, k, v, lens, 0, m, l,
                                                  acc, 512, ""),
        "partial_launch": lambda: lib.repro_flash_partial(*pargs),
        "combine_op": lambda: ops.flash_combine(m, l, acc, None, None, None,
                                                out, True, ""),
        "combine_impl": lambda: kfa._combine_cuda(m, l, acc, None, None,
                                                  None, out, True, ""),
        "combine_launch": lambda: lib.repro_flash_combine(*cargs),
        "lib": kfa._lib}
    saved = (kfa.flash_partial.launches, kfa.flash_combine.launches)
    times = {name: [] for name in calls}
    for fn in calls.values():
        fn()
    for _ in range(rounds):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times[name].append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    kfa.flash_partial.launches, kfa.flash_combine.launches = saved
    return {name: statistics.median(t) for name, t in times.items()}


def phase_baseline_serve(report, card, base):
    """Phase 14 (c)'s serving cell from the base tree and this one, each
    process on its own (:func:`serve_child`), in the turns of
    :data:`SERVE_ORDER`: decode tok/s and device ops a step; and the host
    cost of this tree's ``torch.library`` operators for kernel 2
    (:func:`library_dispatch_us`), which the base tree calls directly."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"base": base, "this": here}
    runs = {"base": [], "this": []}
    for who in SERVE_ORDER:
        runs[who].append(serve_child(trees[who]))
    tok = {w: [t for r in rs for t in r["tok_s"]] for w, rs in runs.items()}
    ops = {w: [r["device_ops_per_step"] for r in rs]
           for w, rs in runs.items()}
    # pair i: the i-th process of each tree, adjacent in SERVE_ORDER
    mean = {w: [statistics.mean(r["tok_s"]) for r in rs]
            for w, rs in runs.items()}
    pairs = [t / b for b, t in zip(mean["base"], mean["this"])]
    q = statistics.quantiles(mean["base"], n=4)
    us = library_dispatch_us()
    layers = 28                                 # llama3.2-3b
    extra_ms = layers * (us["partial_op"] - us["partial_impl"]
                         + us["combine_op"] - us["combine_impl"]) / 1e3
    report["baseline_serve"] = {"runs": runs, "pair_ratios": pairs,
                                "library_dispatch_us": us,
                                "library_ms_per_step": extra_ms}
    med = {w: statistics.median(t) for w, t in mean.items()}
    say("base", f"serve {SERVE_TURN[0]} bf16 B={SERVE_TURN[1]} prompt "
                f"{SERVE_TURN[2]} gen {SERVE_TURN[3]}, {len(SERVE_ORDER)} "
                f"processes in ABBA turns, {SERVE_REPS} timed runs each: "
                f"decode tok/s base {json.dumps(tok['base'])}, this tree "
                f"{json.dumps(tok['this'])}; process means' medians "
                f"{med['base']:.2f} / {med['this']:.2f} "
                f"({med['this'] / med['base']:.3f}x), the base's quartiles "
                f"{q[0]:.2f}-{q[2]:.2f}; this tree faster in "
                f"{sum(r > 1 for r in pairs)} of {len(pairs)} pairs (ratios "
                f"{json.dumps(pairs)}); device ops a step base "
                f"{json.dumps(ops['base'])}, this tree "
                f"{json.dumps(ops['this'])}; card {card}")
    say("base", f"kernel 2's passes at llama3.2-3b's step, host us a call "
                f"(median of 5 rounds of 500), through torch.library / its "
                f"CUDA implementation called directly / the C launch alone: "
                f"partial {us['partial_op']:.2f} / {us['partial_impl']:.2f} "
                f"/ {us['partial_launch']:.2f}, combine "
                f"{us['combine_op']:.2f} / {us['combine_impl']:.2f} / "
                f"{us['combine_launch']:.2f}; _lib() {us['lib']:.2f}; the "
                f"operators add {extra_ms:.3f} ms a step of {layers} layers;"
                f" card {card}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="another checkout of the repository (e.g. a git "
                         "archive of the parent commit): time its kernels "
                         "1 and 2 and MMOOC walls beside this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_env()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_kernels(gen)
    phase_kernels_attention(gen)
    phase_kernels_direct(gen)
    report = {"main_path": [], "attention": [], "c1": [], "factor": [],
              "fault": [], "tune": [], "hybrid": [], "hybrid_plans": {},
              "analyze": [], "serve": [], "train": [], "mesh": [],
              "dryrun": [], "claims": [],
              "factor_panel_ms": {}, "factor_dgemm_check": {},
              "launches": {}, "launches_by_dtype": {}}
    A, B, C, host_out, params = phase_main(gen, report)
    syrk = phase_vmem_syrk(gen, report, A, B, C, host_out, params)
    phase_c1(gen, report, A, B, C, host_out, params)
    if args.baseline:
        phase_baseline(gen, report, card, args.baseline, A, B, C, params)
    attn = phase_attention(gen, report)
    bf16_io = phase_main_bf16(gen, report, args.baseline)
    factors = phase_factor(gen, report)
    phase_faults(report, A, B, C, host_out, params, factors)
    tuned = phase_tune(gen, report, card, A, B, C, host_out, params, factors)
    hplan = phase_hybrid(gen, report, A, B, C, host_out, params, syrk, attn)
    phase_analyze(report, card, (A, B, C, host_out, params), bf16_io, syrk,
                  attn, factors, hplan, tuned)
    main_io = (A, B, C, host_out, params)     # host tensors, for phase 16
    del A, B, C, host_out, syrk, attn, factors
    phase_serve(report, card)
    phase_train(report, card)
    phase_mesh(report, card, main_io, bf16_io)
    del main_io, bf16_io
    phase_dryrun(report, card, gen)
    phase_claims(report, card, gen, tuned[0])
    if args.baseline:
        phase_baseline_serve(report, card, args.baseline)
    entries = [*phase_timing(gen, report, card),
               phase_timing_attention(gen, report, card),
               phase_timing_direct(gen, report, card)]
    say("done", f"launches by path {json.dumps(report['launches'])}; "
                f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"main_path": report["main_path"],
                      "attention": report["attention"], "c1": report["c1"],
                      "factor": report["factor"],
                      "factor_panel_ms": report["factor_panel_ms"],
                      "factor_dgemm_check": report["factor_dgemm_check"],
                      "fault": report["fault"],
                      "tune": report["tune"],
                      "hybrid": report["hybrid"],
                      "hybrid_plan_s": report["hybrid_plans"],
                      "analyze": report["analyze"],
                      "serve": report["serve"],
                      "train": report["train"],
                      "mesh": report["mesh"],
                      "dryrun": report["dryrun"],
                      "claims": report["claims"],
                      "baseline_serve": report.get("baseline_serve"),
                      "tune_calibration": report.get("tune_calibration"),
                      "tune_searches": report.get("tune_searches"),
                      "baseline": report.get("baseline"),
                      "baseline_bf16": report.get("baseline_bf16"),
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
