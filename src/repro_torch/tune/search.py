"""Rank the candidate space with ``simulate()`` as the cost oracle.

Port of ``src/repro/tune/search.py`` over the port's ``compile_pipeline``,
``compile_factor_pipeline`` and ``simulate``, held against it by
``tests/test_torch_tune.py``: for one profile a plan equals the
reference's field for field, makespan included.  Dtypes are named as
numpy and torch both name them (``"float32"``, ``"bfloat16"``, ...):
:func:`dtype_name` gives the one spelling a plan and a cache key carry,
and element sizes come from torch, so ``bfloat16`` needs no ml_dtypes.

Every candidate is compiled by the *production* pipeline compiler
(:func:`~repro_torch.core.pipeline.compile_pipeline`) and timed under the
profile's engine model for **that candidate's stream count**
(:meth:`~repro_torch.tune.calibrate.HardwareProfile.model_for`) — the detail
that
reproduces claim C5: on a shared-engine Phi-like profile a 2-stream model
splits the compute core at 0.76 efficiency, so 1 stream wins; on a
GPU-like profile 2 streams hide PCIe behind DGEMM, so 2 wins.  The winner
is returned as a :class:`TunedPlan`, a JSON-serializable value object the
plan cache persists.

The search is exhaustive over the (pruned, tens-of-candidates) space and
fully deterministic: candidates are enumerated in a fixed order and ties
break toward fewer streams, shallower buffers, then larger blocks —
identical inputs always produce an identical plan.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.partitioner import (AttentionPartition, GemmPartition,
                                          plan_attention_partition,
                                          plan_gemm_partition)
from repro_torch.core.pipeline import (attention_pipeline_spec,
                                       compile_factor_pipeline,
                                       compile_pipeline,
                                       factor_pipeline_spec,
                                       gemm_pipeline_spec,
                                       syrk_pipeline_spec)
from repro_torch.core.simulator import FaultModel, simulate
from repro_torch.obs import get_observability
from repro_torch.tune.calibrate import HardwareProfile
from repro_torch.tune.space import attention_search_space, gemm_search_space

Scalar = Union[int, float, bool, str]


def dtype_name(dtype) -> str:
    """One spelling per dtype, as numpy names it: a torch dtype, a numpy
    dtype (ml_dtypes' ``bfloat16`` included) or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".", 1)[1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        t = getattr(torch, str(dtype), None)
        if not isinstance(t, torch.dtype):
            raise
        return str(t).split(".", 1)[1]


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a dtype named as :func:`dtype_name` names it."""
    return torch.empty(0, dtype=getattr(torch, dtype_name(dtype))
                       ).element_size()


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The tuner's output: a complete, executable pipeline configuration.

    ``params`` holds the kernel-specific geometry as a sorted tuple of
    pairs (``bm``/``bn``/``h``/``w`` for GEMM and SYRK, ``bs``/``nblocks``
    for attention) so the dataclass stays frozen, hashable and
    JSON-round-trippable; ``makespan``/``baseline_makespan`` are the
    predicted seconds for this plan and for the hardcoded default
    ``(nstreams=2, nbuf=2)`` plan under the same profile.
    """

    kernel: str                      # "gemm" | "syrk" | "attention"
    problem: Tuple[int, ...]
    dtype: str
    tier: str
    budget: int
    nstreams: int
    nbuf: int
    write_back: bool
    params: Tuple[Tuple[str, int], ...]
    makespan: float
    baseline_makespan: float
    model: str
    fingerprint: str
    # block-grid traversal order and residency eviction policy the schedule
    # is compiled with (defaults match the pre-reuse column-major plans)
    traversal: str = "col"
    evict: str = "lru"

    def param(self, name: str) -> int:
        for k, v in self.params:
            if k == name:
                return v
        raise KeyError(name)

    def gemm_partition(self) -> GemmPartition:
        if self.kernel not in ("gemm", "syrk"):
            raise ValueError(f"{self.kernel!r} plan has no GEMM partition")
        M, N, K = self.problem
        return GemmPartition(
            M, N, K, self.param("h"), self.param("w"),
            self.param("bm"), self.param("bn"),
            dtype_itemsize(self.dtype), self.budget)

    def attention_partition(self) -> AttentionPartition:
        if self.kernel != "attention":
            raise ValueError(f"{self.kernel!r} plan has no KV partition")
        S = self.problem[0]
        return AttentionPartition(
            S, self.param("bs"), self.param("nblocks"),
            dtype_itemsize(self.dtype), self.budget)

    def to_json(self) -> Dict[str, Scalar]:
        d = dataclasses.asdict(self)
        d["problem"] = list(self.problem)
        d["params"] = {k: v for k, v in self.params}
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "TunedPlan":
        d = dict(d)
        d["problem"] = tuple(d["problem"])
        d["params"] = tuple(sorted(d["params"].items()))
        return cls(**d)


def _rank_key(makespan: float, cand_ns: int, cand_nb: int,
              bm: int, bn: int, idx: int):
    # ties: fewer streams, shallower buffers, larger blocks, issue order
    return (makespan, cand_ns, cand_nb, -bm, -bn, idx)


def _observed(label_of):
    """Wrap a ``search_*`` entry point with a ``tune.search`` span plus
    per-search count/latency metrics.  Decorating here (not in AutoTuner)
    covers *every* caller — the tuner, the hybrid balancer's per-device
    searches, direct test calls — with one guard."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            obs = get_observability()
            kernel = label_of(*a, **kw)
            t0 = time.perf_counter()
            with obs.span("tune.search", cat="tune", kernel=kernel):
                plan = fn(*a, **kw)
            if obs.metrics.enabled:
                m = obs.metrics
                m.counter("repro_tune_searches_total",
                          "plan searches run").inc(kernel=kernel)
                m.histogram("repro_tune_search_seconds",
                            "wall seconds per plan search").observe(
                                time.perf_counter() - t0, kernel=kernel)
            return plan
        return wrapper
    return deco


def _count_candidates(kernel: str, n: int) -> None:
    m = get_observability().metrics
    if m.enabled:
        m.counter("repro_tune_candidates_total",
                  "pipeline candidates ranked by simulate()").inc(
                      n, kernel=kernel)


@_observed(lambda *a, **kw: kw.get("kernel", "gemm"))
def search_gemm(
    M: int,
    N: int,
    K: int,
    budget_bytes: int,
    profile: HardwareProfile,
    *,
    kernel: str = "gemm",
    dtype: str = "float32",
    tier: str = "HBM",
    fingerprint: str = "",
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (1, 2, 3),
    write_back_options: Sequence[bool] = (True,),
    traversal_options: Sequence[str] = ("col", "serpentine", "blocked",
                                        "zmorton"),
    evict_options: Sequence[str] = ("lru", "belady"),
    max_steps: int = 2048,
    fault_rate: float = 0.0,
    fault_model: Optional[FaultModel] = None,
) -> TunedPlan:
    """Exhaustively rank the pruned GEMM/SYRK space under ``profile``.

    ``fault_rate`` (or an explicit ``fault_model``) ranks candidates by
    *expected* makespan under the simulator's faulted mode (DESIGN.md
    §12) — plans with more transfer ops pay proportionally more retry
    tax, so the winner can differ from the fault-free one.

    Element size derives from ``dtype`` (the plan embeds both; deriving
    keeps the searched bytes and the reconstructed partition consistent).
    Traversal and eviction policy are searched jointly with the pipeline
    shape: Belady never *misses* more than LRU on a static schedule, but
    its eviction waits can stall the transfer stream behind far-future
    consumers, so makespan — not bytes — arbitrates, and the winning plan
    records both knobs so entry points replay the ranked schedule byte for
    byte.
    """
    if kernel not in ("gemm", "syrk"):
        raise ValueError(f"search_gemm cannot tune kernel {kernel!r}")
    if kernel == "syrk" and set(write_back_options) != {True}:
        # the SYRK spec has no resident-C mode; ranking a policy the
        # compiled schedule can't express would record a fictional makespan
        raise ValueError("syrk pipelines always write back; "
                         "write_back_options must be (True,)")
    bytes_per_el = dtype_itemsize(dtype)
    if kernel == "gemm":
        spec_of = gemm_pipeline_spec
    else:
        def spec_of(part, write_back=True, traversal="col", band=None):
            return syrk_pipeline_spec(part, traversal=traversal, band=band)
    space = gemm_search_space(
        M, N, K, budget_bytes, bytes_per_el,
        nstreams_options=nstreams_options, nbuf_options=nbuf_options,
        write_back_options=write_back_options,
        traversal_options=traversal_options, evict_options=evict_options,
        max_steps=max_steps)
    if not space:
        raise ValueError(
            f"no feasible pipeline configuration for GEMM {(M, N, K)} "
            f"within {budget_bytes}B (max_steps={max_steps})")
    _count_candidates(kernel, len(space))
    fm = fault_model if fault_model is not None else (
        FaultModel(fault_rate) if fault_rate > 0 else None)

    best = None
    best_key = None
    for idx, cand in enumerate(space):
        sched = compile_pipeline(
            spec_of(cand.part, write_back=cand.write_back,
                    traversal=cand.traversal, band=cand.nbuf),
            nstreams=cand.nstreams, nbuf=cand.nbuf, evict=cand.evict)
        res = simulate(sched, profile.model_for(cand.nstreams),
                       faults=fm)
        key = _rank_key(res.makespan, cand.nstreams, cand.nbuf,
                        cand.part.bm, cand.part.bn, idx)
        if best_key is None or key < best_key:
            best, best_key = (cand, res), key

    # baseline: the hardcoded default every entry point used before tuning
    try:
        dpart = plan_gemm_partition(M, N, K, budget_bytes, bytes_per_el)
        dres = simulate(compile_pipeline(spec_of(dpart), nstreams=2, nbuf=2),
                        profile.model_for(2), faults=fm)
        baseline = dres.makespan
    except ValueError:
        baseline = float("inf")

    cand, res = best
    return TunedPlan(
        kernel=kernel,
        problem=(M, N, K),
        dtype=dtype,
        tier=tier,
        budget=budget_bytes,
        nstreams=cand.nstreams,
        nbuf=cand.nbuf,
        write_back=cand.write_back,
        params=tuple(sorted({
            "h": cand.part.h, "w": cand.part.w,
            "bm": cand.part.bm, "bn": cand.part.bn,
        }.items())),
        makespan=res.makespan,
        baseline_makespan=baseline,
        model=profile.name,
        fingerprint=fingerprint,
        traversal=cand.traversal,
        evict=cand.evict,
    )


@_observed(lambda kind, *a, **kw: f"{kind}-factor")
def search_factor(
    kind: str,
    n: int,
    panel: int,
    budget_bytes: int,
    profile: HardwareProfile,
    *,
    dtype: str = "float32",
    tier: str = "HBM",
    fingerprint: str = "",
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (1, 2, 3),
    lookahead_options: Sequence[int] = (0, 1, 2),
    evict_options: Sequence[str] = ("lru", "belady"),
    max_steps: int = 4096,
    fault_rate: float = 0.0,
    fault_model: Optional[FaultModel] = None,
) -> TunedPlan:
    """Rank whole-factorization pipelines under ``profile``.

    ``fault_rate``/``fault_model`` rank by expected makespan under faults
    exactly as in :func:`search_gemm`.

    A factorization's trailing shapes *shrink* every panel, so instead of
    caching one plan per trailing shape (the pre-pipeline wrapper's
    behavior: a separate search for every ``ooc_syrk`` call), the whole run
    is one search keyed by ``(n, panel)``: each candidate — panel width
    ladder x (nstreams, nbuf, lookahead) — compiles the complete
    multi-panel schedule through the production
    :func:`~repro_torch.core.pipeline.compile_factor_pipeline` and is timed end
    to end by ``simulate()``, shrinking grids included.  The plan's params
    carry the chosen ``panel``/``bm``/``bn``/``lookahead``; the
    factored-row cache's eviction policy is searched alongside (as in
    :func:`search_gemm`, makespan arbitrates between LRU's unstalled
    transfers and Belady's fewer of them) and recorded on the plan.
    """
    if kind not in ("cholesky", "lu"):
        raise ValueError(f"search_factor cannot tune kernel {kind!r}")
    bytes_per_el = dtype_itemsize(dtype)
    panels = []
    pw = min(panel, n)
    while pw >= 1 and len(panels) < 3:
        panels.append(pw)
        pw //= 2

    fm = fault_model if fault_model is not None else (
        FaultModel(fault_rate) if fault_rate > 0 else None)
    best = None
    best_key = None
    baseline = None       # the hardcoded default, when rankable
    seq_best = None       # best sequential candidate at the requested panel
    idx = 0
    for pw in panels:
        for ns in nstreams_options:
            for nb in nbuf_options:
                for la in lookahead_options:
                    try:
                        spec = factor_pipeline_spec(
                            n, pw, budget_bytes, bytes_per_el,
                            kind=kind, lookahead=la, nbuf=nb)
                    except ValueError:
                        continue
                    for ev in evict_options:
                        sched = compile_factor_pipeline(spec, nstreams=ns,
                                                        nbuf=nb, evict=ev)
                        if len(sched.ops) > max_steps:
                            continue
                        res = simulate(sched, profile.model_for(ns),
                                       faults=fm)
                        # sequential default: the per-panel loop every
                        # entry point ran before lookahead existed
                        if (pw == panels[0] and ns == 2 and nb == 2
                                and la == 0 and ev == "lru"):
                            baseline = res.makespan
                        if pw == panels[0] and la == 0 and ev == "lru" and (
                                seq_best is None or res.makespan < seq_best):
                            seq_best = res.makespan
                        key = (res.makespan, ns, nb, la, -spec.bm,
                               -spec.bn, idx)
                        if best_key is None or key < best_key:
                            best, best_key = (spec, ns, nb, ev, res), key
                        idx += 1
    _count_candidates(f"{kind}-factor", idx)
    if best is None:
        raise ValueError(
            f"no feasible {kind} pipeline for n={n}, panel<={panel} "
            f"within {budget_bytes}B (max_steps={max_steps})")

    spec, ns, nb, ev, res = best
    if baseline is None:
        # the exact (ns=2, nb=2, la=0) default was outside the option sets
        # or infeasible: fall back to the best sequential candidate, then
        # to the winner itself — the field must stay finite and
        # JSON-portable
        baseline = seq_best if seq_best is not None else res.makespan
    return TunedPlan(
        kernel=f"{kind}-factor",
        problem=(n, panel),
        dtype=dtype,
        tier=tier,
        budget=budget_bytes,
        nstreams=ns,
        nbuf=nb,
        write_back=True,
        params=tuple(sorted({
            "panel": spec.panel, "bm": spec.bm, "bn": spec.bn,
            "lookahead": spec.lookahead,
        }.items())),
        makespan=res.makespan,
        baseline_makespan=baseline,
        model=profile.name,
        fingerprint=fingerprint,
        evict=ev,
    )


@_observed(lambda *a, **kw: "attention")
def search_attention(
    seq_len: int,
    kv_heads: int,
    head_dim: int,
    q_heads: int,
    budget_bytes: int,
    profile: HardwareProfile,
    *,
    dtype: str = "float16",
    tier: str = "HBM",
    fingerprint: str = "",
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (2, 3),
    max_steps: int = 4096,
) -> TunedPlan:
    """Exhaustively rank KV block length x pipeline shape under ``profile``."""
    bytes_per_el = dtype_itemsize(dtype)
    space = attention_search_space(
        seq_len, kv_heads, head_dim, budget_bytes, bytes_per_el,
        nstreams_options=nstreams_options, nbuf_options=nbuf_options,
        max_steps=max_steps)
    if not space:
        raise ValueError(
            f"no feasible attention configuration for S={seq_len} "
            f"within {budget_bytes}B")
    _count_candidates("attention", len(space))

    best = None
    best_key = None
    for idx, cand in enumerate(space):
        spec = attention_pipeline_spec(cand.part, kv_heads, head_dim, q_heads)
        res = simulate(compile_pipeline(spec, nstreams=cand.nstreams,
                                        nbuf=cand.nbuf),
                       profile.model_for(cand.nstreams))
        key = _rank_key(res.makespan, cand.nstreams, cand.nbuf,
                        cand.part.bs, 0, idx)
        if best_key is None or key < best_key:
            best, best_key = (cand, res), key

    try:
        dpart = plan_attention_partition(seq_len, kv_heads, head_dim,
                                         budget_bytes, bytes_per_el)
        dspec = attention_pipeline_spec(dpart, kv_heads, head_dim, q_heads)
        baseline = simulate(compile_pipeline(dspec, nstreams=2, nbuf=2),
                            profile.model_for(2)).makespan
    except ValueError:
        baseline = float("inf")

    cand, res = best
    return TunedPlan(
        kernel="attention",
        problem=(seq_len, kv_heads, head_dim, q_heads),
        dtype=dtype,
        tier=tier,
        budget=budget_bytes,
        nstreams=cand.nstreams,
        nbuf=cand.nbuf,
        write_back=False,
        params=tuple(sorted({
            "bs": cand.part.bs, "nblocks": cand.part.nblocks,
        }.items())),
        makespan=res.makespan,
        baseline_makespan=baseline,
        model=profile.name,
        fingerprint=fingerprint,
    )
