"""Port of ``src/repro/obs/whatif.py`` (JAX-free), held against it by
``tests/test_torch_analyze.py`` (scenarios and ranking equal) and run on
the card's calibrated profile by ``chip_smoke.py`` (``[analyze]`` lines); a
copy of the reference apart from its imports.  Element sizes come from the
port's :func:`~repro_torch.tune.search.dtype_itemsize`, which also knows
``bfloat16`` without ml_dtypes.

What-if sensitivity: which resource buys the next makespan reduction?

The attribution layer (:mod:`repro_torch.obs.analyze`) names the
bottleneck; this module *quantifies the alternatives*: re-run
``simulate()`` under scaled
:class:`~repro_torch.tune.calibrate.HardwareProfile` knobs — transfer
bandwidth ×k, compute rate ×k, one stream more/fewer, one pipeline buffer
more/fewer — and report the marginal makespan gain of each.  Bandwidth
and flops scenarios reuse the baseline schedule under a replaced profile;
stream and buffer scenarios recompile through ``compile_fn`` because the
pipeline shape (and, via the partitioner, the block geometry) changes with
them.

This is also the explanation layer for tuner choices (claim C5): on the
canned gpu profile at the paper's 8192³ fp64 regime, "+1 stream" from a
1-stream baseline gains roughly a full transfer phase — more than
"bandwidth ×1.25" — which is *why* the tuner picks 2 streams; on the
phi-like profile "+1 stream" has negative gain (the 0.76 thread-split
efficiency), so among the stream/buffer/bandwidth knobs more bandwidth
helps most and the tuner stays at 1 stream.
``tests/test_torch_analyze.py`` pins both rankings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.simulator import simulate
from repro_torch.core.streams import Schedule

#: knob families a scenario can belong to
KNOBS = ("baseline", "bandwidth", "flops", "streams", "buffers")

CompileFn = Callable[[int, int], Schedule]     # (nstreams, nbuf) -> Schedule


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One simulated configuration next to the baseline."""

    name: str
    knob: str                 # one of KNOBS
    nstreams: int
    nbuf: int
    makespan: float           # inf when infeasible
    gain_seconds: float       # baseline - makespan (negative = worse)
    speedup: float            # baseline / makespan
    feasible: bool = True
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class WhatIfReport:
    """Baseline + scenarios, ranked by marginal makespan gain."""

    baseline: Scenario
    scenarios: List[Scenario]

    def ranked(self, knobs: Optional[Sequence[str]] = None
               ) -> List[Scenario]:
        """Feasible non-baseline scenarios, best gain first (optionally
        restricted to a knob subset, e.g. the purchasable resources)."""
        out = [s for s in self.scenarios
               if s.feasible and s.knob != "baseline"
               and (knobs is None or s.knob in knobs)]
        return sorted(out, key=lambda s: (-s.gain_seconds, s.name))

    def best(self, knobs: Optional[Sequence[str]] = None
             ) -> Optional[Scenario]:
        r = self.ranked(knobs)
        return r[0] if r else None

    def scenario(self, name: str) -> Scenario:
        for s in self.scenarios:
            if s.name == name:
                return s
        raise KeyError(name)

    def to_json(self) -> dict:
        return {
            "baseline": self.baseline.to_json(),
            "scenarios": [s.to_json() for s in self.scenarios],
            "ranked": [s.name for s in self.ranked()],
        }


def whatif(compile_fn: CompileFn, profile, nstreams: int, nbuf: int,
           *, scale: float = 1.25) -> WhatIfReport:
    """Sensitivity table around the ``(nstreams, nbuf)`` baseline.

    ``compile_fn(nstreams, nbuf)`` must return the schedule for that
    configuration (raising ``ValueError`` marks the scenario infeasible —
    e.g. a buffer count the memory budget cannot hold).
    """
    base_sched = compile_fn(nstreams, nbuf)
    base_span = simulate(base_sched, profile.model_for(nstreams)).makespan
    baseline = Scenario(name="baseline", knob="baseline",
                        nstreams=nstreams, nbuf=nbuf, makespan=base_span,
                        gain_seconds=0.0, speedup=1.0)
    scenarios: List[Scenario] = [baseline]

    def add(name: str, knob: str, ns: int, nb: int,
            run: Callable[[], float], note: str = "") -> None:
        try:
            span = run()
        except ValueError as e:
            scenarios.append(Scenario(
                name=name, knob=knob, nstreams=ns, nbuf=nb,
                makespan=float("inf"), gain_seconds=float("-inf"),
                speedup=0.0, feasible=False, note=str(e)))
            return
        scenarios.append(Scenario(
            name=name, knob=knob, nstreams=ns, nbuf=nb, makespan=span,
            gain_seconds=base_span - span,
            speedup=base_span / span if span > 0 else float("inf"),
            note=note))

    bw = dataclasses.replace(profile, h2d_bw=profile.h2d_bw * scale,
                             d2h_bw=profile.d2h_bw * scale)
    add(f"bandwidth x{scale:g}", "bandwidth", nstreams, nbuf,
        lambda: simulate(base_sched, bw.model_for(nstreams)).makespan,
        note="same schedule, scaled transfer rates")
    fl = dataclasses.replace(profile, flops=profile.flops * scale)
    add(f"flops x{scale:g}", "flops", nstreams, nbuf,
        lambda: simulate(base_sched, fl.model_for(nstreams)).makespan,
        note="same schedule, scaled compute rate")

    def reconfig(ns: int, nb: int) -> Callable[[], float]:
        return lambda: simulate(compile_fn(ns, nb),
                                profile.model_for(ns)).makespan

    add("+1 stream", "streams", nstreams + 1, nbuf,
        reconfig(nstreams + 1, nbuf), note="recompiled pipeline")
    if nstreams > 1:
        add("-1 stream", "streams", nstreams - 1, nbuf,
            reconfig(nstreams - 1, nbuf), note="recompiled pipeline")
    add("+1 buffer", "buffers", nstreams, nbuf + 1,
        reconfig(nstreams, nbuf + 1), note="recompiled pipeline")
    if nbuf > 1:
        add("-1 buffer", "buffers", nstreams, nbuf - 1,
            reconfig(nstreams, nbuf - 1), note="recompiled pipeline")

    return WhatIfReport(baseline=baseline, scenarios=scenarios)


def whatif_gemm(M: int, N: int, K: int, budget_bytes: int, profile, *,
                kernel: str = "gemm", dtype: str = "float32",
                nstreams: int = 2, nbuf: int = 2, traversal: str = "col",
                evict: str = "lru", write_back: bool = True,
                scale: float = 1.25) -> WhatIfReport:
    """What-if table for a GEMM/SYRK problem: each stream/buffer scenario
    re-partitions (the working set depends on both) and recompiles through
    the production pipeline compiler."""
    from repro_torch.core.partitioner import plan_gemm_partition
    from repro_torch.core.pipeline import (compile_pipeline,
                                           gemm_pipeline_spec,
                                           syrk_pipeline_spec)
    from repro_torch.tune.search import dtype_itemsize

    bpe = dtype_itemsize(dtype)

    def compile_fn(ns: int, nb: int) -> Schedule:
        part = plan_gemm_partition(M, N, K, budget_bytes, bpe,
                                   nbuf=nb, nstreams=ns)
        if kernel == "gemm":
            spec = gemm_pipeline_spec(part, write_back=write_back,
                                      traversal=traversal, band=nb)
        elif kernel == "syrk":
            spec = syrk_pipeline_spec(part, traversal=traversal, band=nb)
        else:
            raise ValueError(f"whatif_gemm cannot compile {kernel!r}")
        return compile_pipeline(spec, nstreams=ns, nbuf=nb, evict=evict)

    return whatif(compile_fn, profile, nstreams, nbuf, scale=scale)


def whatif_plan(plan, profile, *, scale: float = 1.25) -> WhatIfReport:
    """What-if table around a :class:`~repro_torch.tune.search.TunedPlan`'s
    configuration, replaying its traversal/eviction choices.

    The baseline replays the plan's *stored* block geometry
    (``plan.gemm_partition()``) — the tuner searches geometry directly and
    can pick blocks the budget-driven partitioner would refuse — while
    changed stream/buffer counts re-partition; when the plan's budget
    cannot hold the changed configuration the scenario simply reports
    infeasible."""
    from repro_torch.core.partitioner import plan_gemm_partition
    from repro_torch.core.pipeline import (compile_pipeline,
                                           gemm_pipeline_spec,
                                           syrk_pipeline_spec)
    from repro_torch.tune.search import dtype_itemsize

    if plan.kernel not in ("gemm", "syrk"):
        raise ValueError(f"whatif_plan cannot recompile {plan.kernel!r}")
    M, N, K = plan.problem
    bpe = dtype_itemsize(plan.dtype)

    def compile_fn(ns: int, nb: int) -> Schedule:
        if (ns, nb) == (plan.nstreams, plan.nbuf):
            part = plan.gemm_partition()
        else:
            part = plan_gemm_partition(M, N, K, plan.budget, bpe,
                                       nbuf=nb, nstreams=ns)
        if plan.kernel == "gemm":
            spec = gemm_pipeline_spec(part, write_back=plan.write_back,
                                      traversal=plan.traversal, band=nb)
        else:
            spec = syrk_pipeline_spec(part, traversal=plan.traversal,
                                      band=nb)
        return compile_pipeline(spec, nstreams=ns, nbuf=nb,
                                evict=plan.evict)

    return whatif(compile_fn, profile, plan.nstreams, plan.nbuf,
                  scale=scale)
