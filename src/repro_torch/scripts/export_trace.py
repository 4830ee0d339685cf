"""Export an OOC pipeline timeline as chrome://tracing JSON.

Port of ``scripts/export_trace.py``.  Span sources, one trace format
(``repro_torch.core.trace``):

  * ``--mode sim``  — engine-model spans from ``simulate()`` under a named
    hardware model: what the schedule *predicts* (the C3/C5 overlap story).
  * ``--mode exec`` — measured spans from ``ScheduleExecutor`` running the
    schedule on random data with ``record_spans=True``, on the card (the
    host with ``--cpu``), in the executor's ``concurrent`` mode.  On the
    card each op's span comes from CUDA events recorded on the stream
    that runs it, with no per-op synchronize, so the spans keep the
    overlap the executor achieves: H2D, compute and D2H overlap on their
    own streams.  A span starts after the op's host preparation (an
    H2D's fill of pinned staging), so host time shows as gaps.  On the
    host the spans come from the host clock around each op.
  * ``--mode hybrid`` — engine-model spans of a GEMM co-scheduled across
    the canned gpu+phi profile pair: one trace *process* (lane-group, pid =
    device index) per device, so the balanced concurrent timelines sit side
    by side without stream-id collisions.
  * ``--mode factor`` — engine-model spans of a whole factorization
    schedule (``--kind cholesky|lu``): panel ops, lookahead overlap and the
    streamed trailing update on one timeline.

GEMM and factor traces carry the schedule's block-cache counters as an
instant "reuse" annotation (hits = transfers *not* on the timeline);
``--traversal``/``--evict`` pick the step order and eviction policy so the
elided-transfer effect is visible by diffing two exports.  Every trace's
``otherData`` holds the modeled byte totals and the
:class:`~repro_torch.obs.analyze.TraceAnalysis` digest of its spans.  The
hardware models are the port's ``gpu`` and ``phi``: it holds no TPU rates.

Open the output at chrome://tracing or https://ui.perfetto.dev.

Example:
    python -m repro_torch.scripts.export_trace --mode exec \\
        --M 2048 --N 2048 --K 1024 --budget-mb 16 -o trace.json
    python -m repro_torch.scripts.export_trace --mode sim --hw gpu \\
        -o trace.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core import (EVICT_POLICIES, TRAVERSALS, OpKind,
                              ScheduleExecutor, build_gemm_schedule,
                              chrome_trace, compile_factor_pipeline,
                              factor_pipeline_spec, gpu_like, phi_like,
                              plan_gemm_partition, simulate)
from repro_torch.obs.analyze import TraceAnalysis

HW = {
    "gpu": lambda ns: gpu_like(),
    "phi": lambda ns: phi_like(nstreams=ns),
}

# informational output; rebound to stderr when the trace itself goes to
# stdout (--out -) so the JSON stays parseable
log = print


def _summarize(doc: dict) -> str:
    """Per-pid digest of a Chrome-trace doc: lane name, span count, busy
    milliseconds per category, and utilization (busy / (wall span × lanes))
    — plus the modeled byte totals and attribution digest when the
    exporting mode attached them (``otherData``)."""
    lanes: dict = {}
    for e in doc.get("traceEvents", ()):
        pid = e.get("pid", 0)
        lane = lanes.setdefault(pid, {"name": f"pid {pid}", "spans": 0,
                                      "busy_ms": {}, "tids": set(),
                                      "t0": None, "t1": None})
        if e.get("ph") == "M" and e.get("name") == "process_name":
            lane["name"] = e["args"]["name"]
        elif e.get("ph") == "X":
            lane["spans"] += 1
            cat = e.get("cat", "span")
            lane["busy_ms"][cat] = (lane["busy_ms"].get(cat, 0.0)
                                    + e.get("dur", 0.0) / 1e3)
            lane["tids"].add(e.get("tid", 0))
            ts, dur = e.get("ts", 0.0), e.get("dur", 0.0)
            lane["t0"] = ts if lane["t0"] is None else min(lane["t0"], ts)
            lane["t1"] = (ts + dur if lane["t1"] is None
                          else max(lane["t1"], ts + dur))
    lines = []
    for pid in sorted(lanes):
        lane = lanes[pid]
        cats = " ".join(f"{c}={ms:.2f}ms"
                        for c, ms in sorted(lane["busy_ms"].items()))
        util = ""
        if lane["t1"] is not None and lane["t1"] > lane["t0"]:
            wall_ms = (lane["t1"] - lane["t0"]) / 1e3
            frac = (sum(lane["busy_ms"].values())
                    / (wall_ms * max(len(lane["tids"]), 1)))
            util = f"  util={frac*100:.0f}%"
        lines.append(f"  pid {pid} [{lane['name']}]: {lane['spans']} spans"
                     + (f"  {cats}" if cats else "") + util)
    for k, v in sorted(doc.get("otherData", {}).items()):
        lines.append(f"  {k}: {v}")
    return "\n".join(lines)


def spans_trace(sched, spans, name: str, analysis: str) -> dict:
    """A schedule's spans as a Chrome-trace doc with the schedule's
    block-cache counters, its modeled byte totals and ``analysis`` (an
    attribution digest) in ``otherData``."""
    doc = chrome_trace(spans, process_name=name, reuse=sched.reuse)
    doc["otherData"] = {"h2d_bytes": sched.total_bytes(OpKind.H2D),
                        "d2h_bytes": sched.total_bytes(OpKind.D2H),
                        "analysis": analysis}
    return doc


def measured_trace(sched, spans, name: str) -> dict:
    """:func:`spans_trace` of an executor's recorded spans, with the
    digest of their tolerance-matched attribution."""
    return spans_trace(sched, spans, name,
                       TraceAnalysis.from_spans(sched, spans).digest())


def _emit(doc: dict, args) -> None:
    """Write the trace doc (``--out -`` = stdout) and, with ``--summary``,
    print the per-pid digest."""
    if args.summary:
        log("summary:")
        log(_summarize(doc))
    if args.out == "-":
        json.dump(doc, sys.stdout)
        sys.stdout.write("\n")
    else:
        with open(args.out, "w") as f:
            json.dump(doc, f)
        log(f"wrote {args.out} — load at chrome://tracing or "
            f"ui.perfetto.dev")


def _hybrid_mode(args) -> None:
    from repro_torch.hybrid import (DeviceSpec, device_schedule,
                                    plan_hybrid_gemm, simulate_hybrid)
    from repro_torch.tune import gpu_profile, phi_profile

    budget = int(args.budget_mb * 2**20)
    devices = [DeviceSpec("gpu0", gpu_profile(), budget),
               DeviceSpec("phi0", phi_profile(), budget)]
    hplan = plan_hybrid_gemm(args.M, args.N, args.K, devices,
                             nbuf_options=(1, 2), max_steps=512)
    sim = simulate_hybrid(hplan)
    for dp, span in zip(hplan.device_plans, sim.device_makespans):
        log(f"  {dp.device.name}: rows [{dp.start}, "
            f"{dp.start + dp.length}) s{dp.plan.nstreams}b{dp.plan.nbuf} "
            f"-> {span*1e3:.2f} ms")
    doc = sim.to_chrome_trace()
    scheds = [device_schedule(hplan, dp) for dp in hplan.device_plans]
    doc["otherData"] = {
        "h2d_bytes": sum(s.total_bytes(OpKind.H2D) for s in scheds),
        "d2h_bytes": sum(s.total_bytes(OpKind.D2H) for s in scheds),
        "analysis": {
            dp.device.name: TraceAnalysis.from_sim(
                sched, res,
                hw=dp.device.profile.model_for(dp.plan.nstreams)).digest()
            for dp, sched, (_, res) in zip(hplan.device_plans, scheds,
                                           sim.per_device)
        },
    }
    log(f"hybrid gemm {args.M}x{args.N}x{args.K}: aggregate makespan "
        f"{sim.makespan*1e3:.2f} ms across {len(hplan.device_plans)} "
        f"devices (one lane-group each)")
    _emit(doc, args)


def _factor_mode(args) -> None:
    budget = int(args.budget_mb * 2**20)
    spec = factor_pipeline_spec(args.n, args.panel, budget, 4,
                                kind=args.kind, lookahead=args.lookahead,
                                nbuf=args.nbuf)
    sched = compile_factor_pipeline(spec, nstreams=args.nstreams,
                                    nbuf=args.nbuf, evict=args.evict)
    res = simulate(sched, HW[args.hw](args.nstreams))
    name = (f"{args.kind} n={args.n} panel={spec.panel} "
            f"la{spec.lookahead} s{args.nstreams}b{args.nbuf} {args.evict}")
    reuse = sched.reuse.get("Fr", {})
    log(f"{name}: {len(sched.ops)} ops, simulated makespan "
        f"{res.makespan*1e3:.2f} ms on {args.hw}; factored-row cache "
        f"{reuse.get('hits', 0)} hits / {reuse.get('misses', 0)} "
        f"transfers")
    doc = spans_trace(sched, res.op_spans, name, TraceAnalysis.from_sim(
        sched, res, hw=HW[args.hw](args.nstreams)).digest())
    _emit(doc, args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("sim", "exec", "hybrid", "factor"),
                    default="sim")
    ap.add_argument("--M", type=int, default=2048)
    ap.add_argument("--N", type=int, default=2048)
    ap.add_argument("--K", type=int, default=1024)
    ap.add_argument("--budget-mb", type=float, default=16.0)
    ap.add_argument("--nstreams", type=int, default=2)
    ap.add_argument("--nbuf", type=int, default=2)
    ap.add_argument("--traversal", choices=TRAVERSALS, default="col",
                    help="block-grid step order (sim/exec modes)")
    ap.add_argument("--evict", choices=EVICT_POLICIES, default="lru",
                    help="block-cache eviction policy (sim/exec/factor)")
    ap.add_argument("--kind", choices=("cholesky", "lu"), default="cholesky",
                    help="factorization kind for --mode factor")
    ap.add_argument("--n", type=int, default=2048,
                    help="matrix order for --mode factor")
    ap.add_argument("--panel", type=int, default=256,
                    help="panel width for --mode factor")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="lookahead depth for --mode factor")
    ap.add_argument("--hw", choices=sorted(HW), default="gpu",
                    help="hardware model for --mode sim and factor")
    ap.add_argument("--cpu", action="store_true",
                    help="--mode exec: run on the host (the kernels' plain "
                         "versions) instead of the card")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="output path; '-' writes the JSON to stdout "
                         "(informational output moves to stderr)")
    ap.add_argument("--summary", action="store_true",
                    help="print a per-pid digest (lane, span count, busy "
                         "ms per category, modeled byte totals)")
    args = ap.parse_args(argv)

    global log
    if args.out == "-":
        log = lambda *a, **kw: print(*a, file=sys.stderr, **kw)  # noqa: E731

    if args.mode == "hybrid":
        _hybrid_mode(args)
        return
    if args.mode == "factor":
        _factor_mode(args)
        return

    budget = int(args.budget_mb * 2**20)
    bpe = 4
    part = plan_gemm_partition(args.M, args.N, args.K, budget, bpe,
                               nbuf=args.nbuf, nstreams=args.nstreams)
    sched = build_gemm_schedule(part, nstreams=args.nstreams, nbuf=args.nbuf,
                                traversal=args.traversal, evict=args.evict)
    name = (f"gemm {args.M}x{args.N}x{args.K} h{part.h}xw{part.w} "
            f"s{args.nstreams}b{args.nbuf} {args.traversal}/{args.evict}")

    if args.mode == "sim":
        hw = HW[args.hw](args.nstreams)
        res = simulate(sched, hw)
        doc = spans_trace(sched, res.op_spans, name,
                          TraceAnalysis.from_sim(sched, res, hw=hw).digest())
        log(f"{name}: {len(sched.ops)} ops, "
            f"simulated makespan {res.makespan*1e3:.2f} ms on {args.hw}")
    else:
        rng = np.random.default_rng(0)
        A = rng.standard_normal((args.M, args.K)).astype(np.float32)
        B = rng.standard_normal((args.K, args.N)).astype(np.float32)
        C = np.zeros((args.M, args.N), dtype=np.float32)
        ex = ScheduleExecutor(record_spans=True, mode="concurrent",
                              torch_device="cpu" if args.cpu else None)
        ex.run(sched, {"A": A, "B": B}, {"C": C}, {"alpha": 1.0, "beta": 0.0})
        spans = ex.last_spans
        total = max(e for _, _, _, e in spans)
        name += f" concurrent on {ex.torch_device.type}"
        doc = measured_trace(sched, spans, name)
        log(f"{name}: {len(spans)} ops executed in {total*1e3:.1f} ms "
            f"of recorded spans")
    _emit(doc, args)


if __name__ == "__main__":
    main()
