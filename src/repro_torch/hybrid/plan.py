"""Hybrid planning: balanced split -> per-device tuned sub-plans.

The balancer decides *how much* each device gets; the tuner decides *how*
each device runs its share.  This module closes the loop by using the tuner
itself as the balance loop's cost oracle: each candidate share is planned
with ``tune.search`` (partition geometry, stream count, buffer depth ranked
by ``simulate()`` under that device's profile) and the plan's makespan is
the predicted finish time the balancer equalizes.  The converged
:class:`HybridPlan` therefore carries per-device ``(GemmPartition,
TunedPlan)`` pairs whose recorded makespans already agree within the
balancer tolerance — the property the reference's
``benchmarks/bench_hybrid.py`` asserts.

Searches are memoized per (device, share), so re-visited shares across
balance iterations cost nothing, and the winning shares' plans are reused
verbatim in the returned ``HybridPlan``.

Port of ``src/repro/hybrid/plan.py`` over the port's
:mod:`repro_torch.tune.search`, held against it by
``tests/test_torch_hybrid.py``: shares and each device's plan
(``to_json()``) equal the reference's.  Dtypes are named through
:func:`~repro_torch.tune.search.dtype_name`, so ``bfloat16`` (a torch
dtype or its name) needs no ml_dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.core.partitioner import (LANE, SUBLANE,
                                          AttentionPartition, GemmPartition)
from repro_torch.hybrid.balance import (BalanceResult, DeviceSpec,
                                        balance_units)
from repro_torch.tune.search import (TunedPlan, dtype_name,
                                     search_attention, search_gemm)


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """One device's slice of the hybrid problem: where it starts, how many
    units it owns, and the tuned pipeline configuration for that
    sub-problem."""

    device: DeviceSpec
    start: int
    length: int
    plan: TunedPlan

    def gemm_partition(self) -> GemmPartition:
        return self.plan.gemm_partition()

    def attention_partition(self) -> AttentionPartition:
        return self.plan.attention_partition()

    @property
    def predicted_makespan(self) -> float:
        return self.plan.makespan


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Complete co-scheduling plan: disjoint contiguous spans covering the
    problem, one tuned sub-plan per active device, plus the balance trail.

    ``problem`` is the *full* problem tuple (``(M, N, K)`` for GEMM/SYRK,
    ``(S, kv_heads, head_dim, q_heads)`` for attention); each
    ``DevicePlan.plan.problem`` is the device's sub-problem.
    """

    kernel: str                        # "gemm" | "syrk" | "attention"
    problem: Tuple[int, ...]
    dtype: str
    device_plans: Tuple[DevicePlan, ...]
    balance: BalanceResult

    @property
    def predicted_makespan(self) -> float:
        """Aggregate prediction: devices run concurrently, so the makespan
        is the slowest device's tuned-plan makespan."""
        return max(dp.plan.makespan for dp in self.device_plans)

    @property
    def tolerance(self) -> float:
        return self.balance.tolerance

    def device_names(self) -> Tuple[str, ...]:
        return tuple(dp.device.name for dp in self.device_plans)


def _as_device_specs(
        devices: Sequence[Union[DeviceSpec, Tuple]]) -> Tuple[DeviceSpec, ...]:
    """Accept DeviceSpec objects or bare (name, profile, budget) tuples —
    the entry-point-friendly spelling ``ooc_gemm(devices=[...])`` takes."""
    out = []
    for i, d in enumerate(devices):
        if isinstance(d, DeviceSpec):
            out.append(d)
        else:
            out.append(DeviceSpec(*d))
    if not out:
        raise ValueError("devices must be a non-empty sequence")
    names = [d.name for d in out]
    if len(set(names)) != len(names):
        raise ValueError(f"device names must be unique, got {names}")
    return tuple(out)


def _assemble(kernel: str, problem: Tuple[int, ...], dtype: str,
              devices: Tuple[DeviceSpec, ...], bal: BalanceResult,
              memo: Dict[Tuple[int, int], Optional[TunedPlan]]) -> HybridPlan:
    plans = []
    start = 0
    for i, share in enumerate(bal.shares):
        if share > 0:
            plan = memo[(i, share)]
            if plan is None:
                raise ValueError(
                    f"no feasible {kernel} sub-plan for device "
                    f"{devices[i].name} at share {share} of {bal.total} "
                    f"(budget {devices[i].budget_bytes}B)")
            plans.append(DevicePlan(devices[i], start, share, plan))
        start += share
    return HybridPlan(kernel, problem, dtype, tuple(plans), bal)


def plan_hybrid_gemm(
    M: int,
    N: int,
    K: int,
    devices: Sequence[Union[DeviceSpec, Tuple]],
    *,
    kernel: str = "gemm",
    dtype: str = "float32",
    tolerance: float = 0.05,
    max_iters: int = 16,
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (1, 2, 3),
    max_steps: int = 2048,
) -> HybridPlan:
    """Balance a GEMM (or SYRK) row split and tune each device's band.

    Device i computes C rows ``[start_i, start_i + length_i)``: its
    sub-problem is a ``length_i x N x K`` GEMM against the full B (SYRK: the
    full transposed panel), planned by ``tune.search`` under its own profile
    and budget.  The returned plan's per-device predicted makespans agree
    within ``tolerance`` whenever the balancer converged.
    """
    if kernel not in ("gemm", "syrk"):
        raise ValueError(f"plan_hybrid_gemm cannot plan kernel {kernel!r}")
    devs = _as_device_specs(devices)
    dtype = dtype_name(dtype)
    memo: Dict[Tuple[int, int], Optional[TunedPlan]] = {}

    def cost(i: int, rows: int) -> float:
        key = (i, rows)
        if key not in memo:
            try:
                memo[key] = search_gemm(
                    rows, N, K, devs[i].budget_bytes, devs[i].profile,
                    kernel=kernel, dtype=dtype, tier=devs[i].tier,
                    fingerprint=f"hybrid-{devs[i].name}",
                    nstreams_options=nstreams_options,
                    nbuf_options=nbuf_options, max_steps=max_steps)
            except ValueError:
                memo[key] = None
        plan = memo[key]
        return plan.makespan if plan is not None else float("inf")

    bal = balance_units(M, len(devs), cost, tolerance=tolerance,
                        max_iters=max_iters, align=SUBLANE)
    return _assemble(kernel, (M, N, K), dtype, devs, bal, memo)


def plan_hybrid_syrk(
    n: int,
    K: int,
    devices: Sequence[Union[DeviceSpec, Tuple]],
    *,
    dtype: str = "float32",
    **kw,
) -> HybridPlan:
    """Row-band SYRK across devices: band i computes ``C[rows_i, :] =
    alpha * P[rows_i, :] @ P^T + beta * C[rows_i, :]`` — a rectangular
    sub-SYRK whose ``Pt`` operand spans the full panel."""
    return plan_hybrid_gemm(n, n, K, devices, kernel="syrk", dtype=dtype,
                            **kw)


def plan_hybrid_attention(
    seq_len: int,
    kv_heads: int,
    head_dim: int,
    q_heads: int,
    devices: Sequence[Union[DeviceSpec, Tuple]],
    *,
    dtype: str = "float16",
    tolerance: float = 0.05,
    max_iters: int = 16,
    nstreams_options: Sequence[int] = (1, 2),
    nbuf_options: Sequence[int] = (2, 3),
    max_steps: int = 4096,
) -> HybridPlan:
    """Balance the KV cache across devices: device i streams positions
    ``[start_i, start_i + length_i)`` and produces an un-normalized
    online-softmax partial ``(m, l, acc)``; the executor merges partials
    exactly (the standard flash-attention combine)."""
    devs = _as_device_specs(devices)
    dtype = dtype_name(dtype)
    memo: Dict[Tuple[int, int], Optional[TunedPlan]] = {}

    def cost(i: int, positions: int) -> float:
        key = (i, positions)
        if key not in memo:
            try:
                memo[key] = search_attention(
                    positions, kv_heads, head_dim, q_heads,
                    devs[i].budget_bytes, devs[i].profile,
                    dtype=dtype, tier=devs[i].tier,
                    fingerprint=f"hybrid-{devs[i].name}",
                    nstreams_options=nstreams_options,
                    nbuf_options=nbuf_options, max_steps=max_steps)
            except ValueError:
                memo[key] = None
        plan = memo[key]
        return plan.makespan if plan is not None else float("inf")

    bal = balance_units(seq_len, len(devs), cost, tolerance=tolerance,
                        max_iters=max_iters, align=LANE)
    return _assemble("attention", (seq_len, kv_heads, head_dim, q_heads),
                     dtype, devs, bal, memo)
