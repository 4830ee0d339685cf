"""Search-space enumeration, pruned by the generalized working-set model.

Port of ``src/repro/tune/space.py`` over the port's planning layer, held
against it by ``tests/test_torch_tune.py``: the same candidates in the same
order.

A candidate is a complete pipeline configuration — partition geometry plus
pipeline shape ``(nstreams, nbuf, write_back)``.  Feasibility is decided by
:meth:`GemmPartition.working_set_bytes(nbuf, nstreams)
<repro_torch.core.partitioner.GemmPartition.working_set_bytes>`, the nbuf-aware
model, so a deeper pipeline is only offered block shapes its larger buffer
allocation still fits (the planner bug the tuner exists to avoid).

The block-shape ladder mirrors the default planner's geometry (aligned
halvings of each dim, M split before N); per (nstreams, nbuf) the largest
feasible ``bn`` is kept for every ``bm`` — the frontier the paper's
partitioner walks — so the space stays tens of candidates, not thousands,
and every candidate is simulated exactly once by the search.  Candidates
whose step count exceeds ``max_steps`` are dropped (compiling a
million-block schedule to rank it would dwarf the savings), and the
enumeration order is deterministic so the search (and its tie-breaks) are
reproducible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.partitioner import (LANE, SUBLANE, AttentionPartition,
                                          GemmPartition,
                                          plan_attention_partition,
                                          plan_gemm_partition)
from repro_torch.obs import get_observability


def _count_pruned(space: str, pruned: Dict[str, int]) -> None:
    """Publish per-reason pruning totals (one call per enumeration, so the
    disabled cost is a single branch)."""
    m = get_observability().metrics
    if m.enabled:
        for reason, n in pruned.items():
            if n:
                m.counter("repro_tune_candidates_pruned_total",
                          "candidates dropped before simulation").inc(
                              n, space=space, reason=reason)


@dataclasses.dataclass(frozen=True)
class GemmCandidate:
    """One point of the GEMM/SYRK space: partition + pipeline shape.

    ``baseline`` marks the hardcoded pre-tuner default (legacy planner,
    ``nstreams=2, nbuf=2``): it is kept in the space so the search can
    never lose to it, even though the legacy working-set model undercounts
    the B ping-pong by one slice and so may sit slightly above what the
    generalized model admits.

    ``traversal`` is the step order over the block grid (see
    :data:`repro_torch.core.partitioner.TRAVERSALS`): it changes which H2D
    transfers the compiler's residency cache can elide, at identical
    working set — so it joins the search space for free.  ``evict`` is the
    cache's replacement policy: Belady elides at least as many transfers as
    LRU, but its eviction waits can stall the transfer stream on
    not-yet-run consumers, so *makespan* must arbitrate — both policies are
    enumerated and ranked."""

    part: GemmPartition
    nstreams: int
    nbuf: int
    write_back: bool = True
    baseline: bool = False
    traversal: str = "col"
    evict: str = "lru"


@dataclasses.dataclass(frozen=True)
class AttentionCandidate:
    """One point of the attention space: KV block length + pipeline shape.

    ``baseline`` marks the pre-tuner default (``plan_attention_partition``
    with ``nstreams=2, nbuf=2``), kept in the space unconditionally."""

    part: AttentionPartition
    nstreams: int
    nbuf: int
    baseline: bool = False


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ladder(dim: int, align: int) -> List[int]:
    """Aligned halvings of ``dim`` down to one tile, largest first."""
    out = []
    b = _round_up(dim, align)
    while b >= align:
        if not out or b != out[-1]:
            out.append(b)
        if b == align:
            break
        b = max(align, _round_up(b // 2, align))
    return out


def _partition(M: int, N: int, K: int, bm: int, bn: int,
               bytes_per_el: int, budget: int) -> GemmPartition:
    return GemmPartition(M, N, K, math.ceil(M / bm), math.ceil(N / bn),
                         bm, bn, bytes_per_el, budget)


def gemm_search_space(
    M: int,
    N: int,
    K: int,
    budget_bytes: int,
    bytes_per_el: int = 4,
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (1, 2, 3),
    write_back_options: Sequence[bool] = (True,),
    traversal_options: Sequence[str] = ("col", "serpentine", "blocked",
                                        "zmorton"),
    evict_options: Sequence[str] = ("lru", "belady"),
    max_steps: int = 2048,
    align_m: int = SUBLANE,
    align_n: int = LANE,
) -> List[GemmCandidate]:
    """Enumerate feasible GEMM pipeline configurations, deterministically.

    The default planner's choice (legacy 2-deep working set, ``nstreams=2,
    nbuf=2``, column-major) is always included when it exists, so the
    search's best is never worse than the hardcoded default under the same
    cost oracle.  Traversals and eviction policies multiply the space
    without changing feasibility (same blocks, different order /
    different elided transfers), and "col"/"lru" enumerate first so exact
    makespan ties resolve to the paper's order and the default policy.
    """
    if budget_bytes <= 0:
        raise ValueError("budget must be positive")
    seen = set()
    out: List[GemmCandidate] = []
    pruned = {"max_steps": 0, "infeasible": 0}

    def add(part: GemmPartition, ns: int, nb: int, wb: bool,
            baseline: bool = False, traversal: str = "col",
            evict: str = "lru") -> None:
        key = (part.bm, part.bn, ns, nb, wb, traversal, evict)
        if key in seen:
            return
        # the baseline is exempt from max_steps: whatever tune=None would
        # run must stay rankable, or the tuner could fail (empty space) or
        # lose to the very default it exists to beat
        if part.nblocks > max_steps and not baseline:
            pruned["max_steps"] += 1
            return
        seen.add(key)
        out.append(GemmCandidate(part, ns, nb, wb, baseline, traversal,
                                 evict))

    # The hardcoded default, as the baseline the tuned plan must beat.
    try:
        default = plan_gemm_partition(M, N, K, budget_bytes, bytes_per_el,
                                      align_m=align_m, align_n=align_n)
        for wb in write_back_options:
            add(default, 2, 2, wb, baseline=True)
    except ValueError:
        pass

    bms = _ladder(M, align_m)
    bns = _ladder(N, align_n)
    for ns in nstreams_options:
        for nb in nbuf_options:
            for wb in write_back_options:
                for bm in bms:
                    # largest feasible bn for this bm under the nbuf-aware
                    # model — the frontier the planner walks
                    for bn in bns:
                        part = _partition(M, N, K, bm, bn,
                                          bytes_per_el, budget_bytes)
                        if part.working_set_bytes(nb, ns) <= budget_bytes:
                            for trav in traversal_options:
                                for ev in evict_options:
                                    add(part, ns, nb, wb, traversal=trav,
                                        evict=ev)
                            break
                        pruned["infeasible"] += 1
    _count_pruned("gemm", pruned)
    return out


def attention_search_space(
    seq_len: int,
    kv_heads: int,
    head_dim: int,
    budget_bytes: int,
    bytes_per_el: int = 2,
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (2, 3),
    max_steps: int = 4096,
    align_s: int = LANE,
) -> List[AttentionCandidate]:
    """Enumerate KV block lengths x pipeline shapes that fit the budget.

    Residency for attention is ``nbuf`` K blocks plus ``nbuf`` V blocks
    (queries and the softmax carry are negligibly small next to the cache),
    so feasibility is ``2 * nbuf * bs * kv_heads * head_dim * bpe <=
    budget``; the default planner's double-buffered choice is always
    included.
    """
    if seq_len <= 0:
        raise ValueError("seq_len must be positive")
    per_pos = 2 * kv_heads * head_dim * bytes_per_el
    seen = set()
    out: List[AttentionCandidate] = []
    pruned = {"max_steps": 0, "infeasible": 0}

    def add(part: AttentionPartition, ns: int, nb: int,
            baseline: bool = False) -> None:
        key = (part.bs, ns, nb)
        if key in seen:
            return
        if part.nblocks > max_steps and not baseline:
            pruned["max_steps"] += 1
            return
        seen.add(key)
        out.append(AttentionCandidate(part, ns, nb, baseline))

    try:
        add(plan_attention_partition(seq_len, kv_heads, head_dim,
                                     budget_bytes, bytes_per_el,
                                     align_s=align_s), 2, 2, baseline=True)
    except ValueError:
        pass

    for ns in nstreams_options:
        for nb in nbuf_options:
            for bs in _ladder(seq_len, align_s):
                if nb * bs * per_pos <= budget_bytes:
                    part = AttentionPartition(
                        seq_len, bs, math.ceil(seq_len / bs),
                        bytes_per_el, budget_bytes)
                    add(part, ns, nb)
                    break
                pruned["infeasible"] += 1
    _count_pruned("attention", pruned)
    return out
