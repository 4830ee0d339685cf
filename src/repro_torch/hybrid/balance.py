"""Functional-performance-model load balancing across unequal devices.

The paper's testbeds host a GPU *and* a Xeon Phi in one node, yet libhclooc
drives one accelerator per kernel call.  Co-execution needs a split of the
problem proportional not to peak flops but to each device's *predicted
pipeline makespan* — transfers, overlap, stream topology and per-op
overhead included — which is exactly what ``simulate()`` under
``profile.model_for(nstreams)`` already computes for single-device tuning.

:func:`balance_units` is the generic loop: split ``total`` work units (C
row bands for GEMM/SYRK, KV positions for attention) across devices so the
predicted per-device makespans equalize.  Each iteration re-allocates
shares proportionally to the measured rates ``share / cost(share)`` — the
functional performance model's fixed point — until the predicted finish
times agree within ``tolerance`` (relative spread).  Devices whose share
rounds below one alignment unit are dropped to zero (their fixed pipeline
overhead is not worth a sliver of work), which is how a dominated profile
degenerates to the single-device partition.

:func:`balance_gemm` instantiates the loop with a direct simulate() cost
oracle (default planner partition, best feasible stream count).  The
planner (``hybrid/plan.py``) instead injects a ``tune.search``-backed
oracle so the converged predictions ARE the per-device ``TunedPlan``
makespans.

Port of ``src/repro/hybrid/balance.py`` (pure Python and numpy over the
port's planning layer and ``tune.calibrate.HardwareProfile``), held
against it by ``tests/test_torch_hybrid.py``: shares and predictions
equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partitioner import SUBLANE, plan_gemm_partition
from repro_torch.core.pipeline import build_gemm_schedule
from repro_torch.core.simulator import simulate
from repro_torch.tune.calibrate import HardwareProfile

# (device_index, units) -> predicted seconds; float("inf") = infeasible.
CostFn = Callable[[int, int], float]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One member of the hybrid device set: identity + engine model + budget.

    The profile supplies the cost oracle (``model_for``), the budget bounds
    each sub-problem's working set, and ``tier`` keys any tuner plan caches.
    """

    name: str
    profile: HardwareProfile
    budget_bytes: int
    tier: str = "HBM"


@dataclasses.dataclass(frozen=True)
class BalanceResult:
    """Converged (or best-seen) split of ``total`` work units.

    ``shares[i]`` is device i's contiguous span (0 = dropped); ``predicted``
    the per-device makespans the cost oracle reported for those shares.
    """

    total: int
    shares: Tuple[int, ...]
    predicted: Tuple[float, ...]
    iterations: int
    tolerance: float
    converged: bool

    @property
    def spread(self) -> float:
        """Relative disagreement of active devices' predicted finish times
        (inf when any active device found its share infeasible)."""
        ts = [t for s, t in zip(self.shares, self.predicted) if s > 0]
        if not all(np.isfinite(t) for t in ts):
            return float("inf")
        if len(ts) <= 1:
            return 0.0
        return (max(ts) - min(ts)) / max(ts)

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.shares) if s > 0)


def surviving_devices(devices: Sequence[DeviceSpec],
                      lost: Sequence[str]) -> List[DeviceSpec]:
    """The device set minus the members named in ``lost`` — the input to
    re-balancing a failed band after a ``device_lost`` fault (DESIGN.md
    §12).  Unknown names are authoring errors and raise, as does losing
    every device (nothing left to rebalance onto)."""
    names = [d.name for d in devices]
    unknown = [n for n in lost if n not in names]
    if unknown:
        raise ValueError(f"lost devices {unknown} not in device set {names}")
    survivors = [d for d in devices if d.name not in set(lost)]
    if not survivors:
        raise ValueError("all devices lost: no survivors to rebalance onto")
    return survivors


def _allocate(total: int, weights: Sequence[float], align: int) -> List[int]:
    """Split ``total`` into contiguous aligned spans proportional to
    ``weights``.  Zero-weight devices (dropped or infeasible) get exactly
    zero — including the rounding/unaligned tail, which must land on a
    device that can actually run it.  Spans always sum to ``total``;
    slivers below one alignment unit fold into the heaviest device (a
    sliver is not worth a device's fixed pipeline overhead)."""
    active = [i for i, w in enumerate(weights) if w > 0]
    if not active:
        raise ValueError("no device has positive weight")
    wsum = sum(weights[i] for i in active)
    shares = [0] * len(weights)
    prev = 0
    acc = 0.0
    for j, i in enumerate(active):
        acc += weights[i]
        if j == len(active) - 1:
            edge = total          # tail (incl. unaligned remainder)
        else:
            edge = min(total, max(
                prev, int(round(acc / wsum * total / align)) * align))
        shares[i] = edge - prev
        prev = edge
    big = max(active, key=lambda i: weights[i])
    for i in active:
        if i != big and 0 < shares[i] < align:
            shares[big] += shares[i]
            shares[i] = 0
    return shares


def balance_units(
    total: int,
    ndev: int,
    cost: CostFn,
    *,
    tolerance: float = 0.05,
    max_iters: int = 16,
    align: int = SUBLANE,
) -> BalanceResult:
    """Equalize predicted makespans of an aligned contiguous split.

    Starts from an even split, then iterates the functional-performance-model
    update (share proportional to measured rate ``share / cost``) until the
    active devices' predictions agree within ``tolerance``.  Infeasible
    shares (``cost`` returns inf — e.g. the sub-problem's K panel overflows
    that device's budget) zero the device's weight, excluding it from later
    rounds.  Returns the best split seen if ``max_iters`` passes without
    convergence (alignment can induce a +-1-block limit cycle).
    """
    if total <= 0:
        raise ValueError("total work must be positive")
    if ndev < 1:
        raise ValueError("need at least one device")
    weights = [1.0] * ndev
    best: Optional[BalanceResult] = None
    for it in range(1, max_iters + 1):
        shares = _allocate(total, weights, align)
        predicted = [cost(i, s) if s > 0 else 0.0 for i, s in
                     enumerate(shares)]
        if all(s == 0 or not np.isfinite(t)
               for s, t in zip(shares, predicted)):
            raise ValueError(
                "no feasible split: every device rejected its share "
                "(budgets too small for the problem's K panel?)")
        res = BalanceResult(total, tuple(shares), tuple(predicted), it,
                            tolerance, converged=False)
        if best is None or res.spread < best.spread:
            best = res
        if res.spread <= tolerance:
            return dataclasses.replace(res, converged=True)
        # functional performance model: rate = units per predicted second
        weights = [s / t if s > 0 and np.isfinite(t) and t > 0 else 0.0
                   for s, t in zip(shares, predicted)]
    return best


def gemm_cost_fn(
    N: int,
    K: int,
    devices: Sequence[DeviceSpec],
    *,
    bytes_per_el: int = 4,
    nstreams_options: Sequence[int] = (1, 2),
    nbuf: int = 2,
) -> CostFn:
    """Direct simulate() oracle: predicted makespan of the default-planner
    pipeline for a ``rows x N x K`` sub-GEMM on device ``i``, taking the
    best feasible stream count (the C5 question answered per device)."""
    memo = {}

    def cost(i: int, rows: int) -> float:
        key = (i, rows)
        if key not in memo:
            dev = devices[i]
            try:
                part = plan_gemm_partition(rows, N, K, dev.budget_bytes,
                                           bytes_per_el)
                memo[key] = min(
                    simulate(build_gemm_schedule(part, nstreams=ns,
                                                 nbuf=nbuf),
                             dev.profile.model_for(ns)).makespan
                    for ns in nstreams_options)
            except ValueError:
                memo[key] = float("inf")
        return memo[key]

    return cost


def balance_gemm(
    M: int,
    N: int,
    K: int,
    devices: Sequence[DeviceSpec],
    *,
    bytes_per_el: int = 4,
    tolerance: float = 0.05,
    max_iters: int = 16,
    nstreams_options: Sequence[int] = (1, 2),
) -> BalanceResult:
    """Profile-proportional row split of C for one GEMM across ``devices``.

    Each device's share is a contiguous band of C rows (A rows split with
    them; B streams whole to every active device), sized so the predicted
    per-device pipeline makespans equalize within ``tolerance``.
    """
    return balance_units(
        M, len(devices),
        gemm_cost_fn(N, K, devices, bytes_per_el=bytes_per_el,
                     nstreams_options=nstreams_options),
        tolerance=tolerance, max_iters=max_iters, align=SUBLANE)
