"""One run of one cell: set-up, the measured window, the comparison, the
metrics, and the result's line.

The cell names its configuration and traffic mix; the configuration names
its entry point, whose driver calls the program and whose reference works
the answers out again.  The harness knows no cell, configuration or metric
by name.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from oocbench.harness import check, profile, traffic as tgen
from oocbench.harness.manifest import Manifest
from oocbench.harness.record import Call, Run, recording_executor

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> List[str]:
    """Of ``names`` (by default the loaded modules), those whose top-level
    name, compared whole, is JAX's or the JAX package's (``repro_torch``
    is neither)."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi rc {out.returncode}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(driver, handle, ex, sets, scalars, config, seconds, flops,
            kept, device, log):
    """Calls back to back, taking the operand sets in turn, until
    ``seconds`` have passed; the window ends with its last call."""
    calls: List[Call] = []
    failed = 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        s = i % len(sets)
        ex.runs.clear()
        c0 = time.perf_counter()
        try:
            with torch.profiler.record_function("oocbench.call"):
                out = driver.call(handle, sets[s], scalars, config)
                _sync(device)
        except Exception:   # a failed call counts; the window goes on
            traceback.print_exc(file=log)
            failed += 1
            i += 1
            continue
        calls.append(Call(operand_set=s, wall_s=time.perf_counter() - c0,
                          flops=flops, execs=list(ex.runs)))
        print(f"[oocbench] call {i} set {s} wall {calls[-1].wall_s!r} s",
              file=log, flush=True)
        with torch.profiler.record_function("oocbench.keep"):
            kept.keep(i, s, out)
        del out
        i += 1
    return calls, failed, i, time.perf_counter() - t0


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             log=sys.stderr) -> dict:
    """Run cell ``name`` of the manifest under ``root`` once; returns the
    result's line as a dict (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    man = Manifest(root)
    cell, config, mix, driver, reference = man.parts(name)
    limits = man.limits(name)
    metrics = man.metrics(name, trace)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    peaks = man.peaks(kind)

    t_ops = time.perf_counter()
    sets = tgen.make_sets(mix, config, seed, device)
    flops = float(reference.useful_flops(tgen.shapes(mix, config)))
    scalars = dict(mix.get("scalars", {}))
    ex = recording_executor(record_spans=trace, torch_device=device)
    handle = driver.prepare(config, ex)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_warm = time.perf_counter()
    # the warm call takes the last set, so the window's first call (set 0)
    # finds other tensors than the call before it
    driver.call(handle, sets[-1], scalars, config)
    _sync(device)
    kept = check.Kept(mix["check"], seed, len(sets))
    setup_s = time.perf_counter() - t_start
    print(f"[oocbench] setup {setup_s!r} s: start and imports "
          f"{t_ops - t_start!r} s, operands {t_warm - t_ops!r} s, warm call "
          f"{t_start + setup_s - t_warm!r} s", file=log, flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if trace \
        else contextlib.nullcontext()
    with prof, torch.profiler.record_function(profile.WINDOW):
        calls, failed, attempted, window_s = _window(
            driver, handle, ex, sets, scalars, config, seconds, flops, kept,
            device, log)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if device.type == "cuda":   # after the window: set-up needs none of it
        print(f"[oocbench] card: {card_line()}", file=log, flush=True)
    run = Run(cell=cell, config=config, traffic=mix, peaks=peaks,
              setup_s=setup_s, window_s=window_s, calls=calls)
    dev: Dict[str, object] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": kind, "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        run.profile = profile.read(prof)
        del prof
        if run.profile is not None:
            dev["busy_s"] = run.profile.busy_s
            dev["window_s"] = run.profile.window_s
            breakdown = {"device_ops": run.profile.device_ops,
                         "idle_gaps": run.profile.idle_gaps}

    # the program's state goes before the reference runs on the device
    del handle, ex
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = {}
    for m in metrics:
        v = man.module("metrics", m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    gaps = check.compare(kept, lambda s: reference.solve(
        {k: v.to(device) for k, v in sets[s].items()}, scalars,
        control=False))
    lim = limits["max_err"]["limit"]
    wrong = sum(1 for g in gaps.values() if not g <= lim)
    checks = {
        "max_err": {"value": max(gaps.values(), default=float("inf")),
                    "limit": lim},
        "failed_calls": {"value": failed + wrong, "limit": 0},
    }
    correct = bool(calls) and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": attempted,
              "failed": failed + wrong, "metrics": values, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"[oocbench] check {k} {c['value']!r} limit {c['limit']!r}",
              file=log, flush=True)
    return result


def main(args, root, t_start: float) -> int:
    if not torch.cuda.is_available():
        print("[oocbench] no CUDA device: nothing is measured",
              file=sys.stderr)
        return 2
    man = Manifest(root)
    chips = int(man.cell(args.workload)["chips"])
    if torch.cuda.device_count() < chips:
        print(f"[oocbench] the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"[oocbench] JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
