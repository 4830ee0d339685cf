"""Out-of-core factorizations — the paper's §VII future work — on one CUDA
device.

Port of ``src/repro/core/ooc_factor.py``, held against it by
``tests/test_torch_factor.py`` and on the card by ``chip_smoke.py``.

The whole factorization is ONE compiled
:class:`~repro_torch.core.streams.Schedule`
(:func:`~repro_torch.core.pipeline.compile_factor_pipeline`) that
interleaves in-core panel ops (POTRF / partial-pivot GETRF, TRSM solves —
the op handlers of ``core/runtime.py``) with the streamed SYRK/GEMM
trailing update, with a *lookahead* parameter: panel ``k+1`` factors while
trailing update ``k`` is still streaming.

Entry points:

  * :func:`ooc_cholesky` — lower-triangular factor of a host-resident SPD
    matrix.
  * :func:`ooc_lu` — right-looking LU with partial pivoting inside the
    resident panel and row-swap replay on write-back; returns ``(LU, perm)``
    with ``A[perm] = tril(LU, -1) + I  @  triu(LU)``.

What differs from the reference: the panel ops run on the executor's
device (cuSOLVER and cuBLAS through ``torch.linalg`` on a card) instead of
in numpy on the host, and the trailing updates run the hand-written block
GEMM (``dgemm`` ops, or ``ooc_syrk``/``ooc_gemm`` on the per-panel loop of
``backend="vmem"``).  A Cholesky whose matrix is not SPD raises
``torch.linalg.LinAlgError`` after the run (the solver's status is read
once, not after every panel).  Inputs are numpy arrays or CPU tensors;
results are CPU tensors in the input's dtype, computed in float32 for
float64 input as the reference computes with JAX's 64-bit mode off.

On a card, ``budget_bytes`` covers the panel ops' device workspace as well
as the schedule's buffers (:func:`panel_workspace_bytes`): the planner
sizes the trailing blocks for what is left.  On the CPU nothing is charged
for the panel ops, as in the reference, so the plans are the reference's.

``tune="auto"`` (``tuner=`` or the process default) plans the panel
width, trailing block dims, stream count, buffer depth, lookahead and
eviction policy with one cached search over the whole factorization.  On
a card that search runs at the budget less the panel ops' workspace at
the *requested* panel width — the most any candidate's narrower panel
needs — and the plan-cache key carries that charged budget; on the CPU
the charge is 0, so the tuned plans are the reference's.

``torch_device`` (default: CUDA) selects where blocks and panels are
computed; with no card the caller passes ``torch_device="cpu"``.
``executor`` runs the host pipeline on a prepared
:class:`~repro_torch.core.runtime.ScheduleExecutor` (its mode, spans and
device).

``faults=``/``fault_policy=`` (host backend) arm fault injection on the
executor (``repro_torch.fault``); an oom, injected, walks the degrade
ladder (halve nbuf, drop lookahead, halve the budget; tuned runs halve
the budget only, each rung re-searched), each rung planned through
:func:`_plan_factor_spec` or :func:`_tuned_factor_spec` (on a card, with
the panel ops' workspace charged), and re-executes clean.

``devices=`` (with ``tolerance=``) takes the per-panel loop, as in the
reference: the panel ops run on ``torch_device`` and each trailing update
is a hybrid ``ooc_syrk``/``ooc_gemm`` across the device set
(``repro_torch.hybrid``), fed from the host matrix.

Each call is one ``obs.call`` (``cholesky``, ``lu``), recorded as in
:mod:`~repro_torch.core.oocgemm` when the executor records spans or a
tracer is active: ``cholesky.intake``, ``cholesky.plan``,
``cholesky.clone_a``, ``cholesky.execute``, ``cholesky.tril`` (``lu.*``
likewise, without the ``tril``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import pipeline as plib
from repro_torch.core.oocgemm import (_check_slice, _entry_call,
                                      _record_host_drift, _torch_device,
                                      ooc_gemm, ooc_syrk)
from repro_torch.core.pipeline import FactorPipelineSpec, factor_pipeline_spec
from repro_torch.core.runtime import (ScheduleExecutor, apply_panel_pivots,
                                      chol_panel_solve, device_tensor,
                                      getrf_panel, host_tensor, lu_row_solve,
                                      prefer_cusolver, raise_on_info)
from repro_torch.core.streams import validate_schedule
from repro_torch.obs import get_observability


# the libraries' device workspace beside the panel ops' own copies: cuBLAS
# keeps up to 32 MiB for each stream it runs on (the TRSMs; a concurrent
# run's panel stream may be new to it, so two streams are charged), and
# cuSOLVER's GETRF took 0.2 MiB at a 24576 x 2048 panel on an H100
# (chip_smoke.py phase 9 measures the panel ops on a fresh stream and
# holds them to panel_workspace_bytes)
_LIBRARY_BYTES = 64 << 20


def panel_workspace_bytes(kind: str, n: int, pw: int, bytes_per_el: int,
                          torch_device) -> int:
    """Device bytes the panel ops take beyond the schedule's buffers at the
    largest panel (``n x pw``), which the planner charges on a card:
    GETRF's column-major copy of the panel, or POTRF's ``pw x pw`` factor,
    plus the libraries' workspace (the TRSMs solve in place).  On the CPU
    nothing: the reference's panel ops run in host memory, uncharged."""
    if torch.device(torch_device).type != "cuda":
        return 0
    own = n * pw if kind == "lu" else pw * pw
    return own * bytes_per_el + _LIBRARY_BYTES


def _plan_factor_spec(kind: str, n: int, panel: int, budget_bytes: int,
                      bytes_per_el: int, lookahead: int, nbuf: int,
                      torch_device="cpu") -> FactorPipelineSpec:
    """Feasible spec for the budget, less the panel ops' device workspace
    at each panel width (:func:`panel_workspace_bytes`), degrading
    gracefully: try the requested (lookahead, panel) first, then drop the
    lookahead buffers, then halve the panel — the panel width is a
    performance hint, not a contract."""
    err: Optional[ValueError] = None
    pw = min(panel, n)
    while pw >= 1:
        ws = panel_workspace_bytes(kind, n, pw, bytes_per_el, torch_device)
        for la in sorted({lookahead, 0}, reverse=True):
            try:
                return factor_pipeline_spec(
                    n, pw, budget_bytes - ws, bytes_per_el,
                    kind=kind, lookahead=la, nbuf=nbuf)
            except ValueError as e:
                err = ValueError(f"{e} (the budget of {budget_bytes}B less "
                                 f"{ws}B of panel-op workspace)") if ws \
                    else e
        pw //= 2
    raise err if err is not None else ValueError(
        f"no feasible {kind} pipeline for n={n} within {budget_bytes}B")


def _tuned_factor_spec(tuner, kind: str, n: int, panel: int,
                       budget_bytes: int, bytes_per_el: int, dtype,
                       torch_device="cpu"):
    """(spec, nstreams, nbuf, evict, plan) from the autotuner's factor plan
    — one cached search covers every shrinking per-panel trailing shape;
    the plan rides along so the caller can record prediction drift.  On a
    card the search and the spec take the budget less the panel ops'
    workspace at the requested panel width (:func:`panel_workspace_bytes`
    grows with the width, and the search tries ``panel``, ``panel/2`` and
    ``panel/4``, so that charge bounds every candidate's)."""
    from repro_torch.tune import get_default_tuner
    from repro_torch.tune.search import dtype_name

    if tuner is None:
        tuner = get_default_tuner()
    ws = panel_workspace_bytes(kind, n, min(panel, n), bytes_per_el,
                               torch_device)
    charged = budget_bytes - ws
    if charged <= 0:
        raise ValueError(f"no feasible {kind} pipeline for n={n}: the "
                         f"budget of {budget_bytes}B less {ws}B of "
                         f"panel-op workspace")
    plan = tuner.factor_plan(kind, n, panel, charged,
                             dtype=dtype_name(dtype))
    spec = factor_pipeline_spec(
        n, plan.param("panel"), charged, bytes_per_el, kind=kind,
        lookahead=plan.param("lookahead"), nbuf=plan.nbuf,
        bm=plan.param("bm"), bn=plan.param("bn"))
    return spec, plan.nstreams, plan.nbuf, plan.evict, plan


def _run_factor(A: torch.Tensor, spec: FactorPipelineSpec, nstreams: int,
                nbuf: int, validate: bool, evict: str = "lru", plan=None,
                executor: Optional[ScheduleExecutor] = None,
                torch_device=None, faults=None, policy=None):
    """Compile + execute the factor schedule over a copy of ``A``; returns
    (factored matrix, executor state) — LU's permutation rides in scratch.

    When a trace is active the executor records its pipeline as the
    ``factor:<kind>`` lane group; a tuned ``plan`` also yields a drift
    record (whole-factorization predicted vs measured)."""
    obs = get_observability()
    kind = spec.kind
    with obs.span(f"{kind}.plan"):
        sched = plib.compile_factor_pipeline(spec, nstreams=nstreams,
                                             nbuf=nbuf, evict=evict)
        if validate:
            validate_schedule(sched)
    with obs.span(f"{kind}.clone_a",
                  copy_bytes=A.numel() * A.element_size()):
        out = A.clone()
    ex = executor or ScheduleExecutor(
        record_spans=obs.tracer is not None,
        trace_group=f"factor:{kind}", torch_device=torch_device)
    with obs.span(f"{kind}.execute"):
        state = ex.run(
            sched, operands={}, outputs={"A": out},
            ctx={"alpha": -1.0, "beta": 1.0, "panel": spec.panel,
                 "n": spec.n},
            faults=faults, policy=policy)
    _record_host_drift(plan, ex, sched, kind)
    return out, state


def _run_factor_resilient(A: torch.Tensor, kind: str,
                          spec: FactorPipelineSpec, nstreams: int, nbuf: int,
                          validate: bool, evict: str, plan=None, *, faults,
                          policy, panel: int, budget_bytes: int,
                          executor: Optional[ScheduleExecutor],
                          torch_device, tune=None, tuner=None):
    """:func:`_run_factor` with the oom degrade ladder (DESIGN.md §12)
    around it: an injected oom aborts the run, after which successive
    rungs — halve nbuf, drop lookahead, halve the budget (tuned plans:
    budget halvings only, each re-searched) — replan through
    :func:`_plan_factor_spec` or :func:`_tuned_factor_spec` until one
    executes.  The degraded re-run is fault-free: the oom occurrence was
    consumed by the failed attempt.  Every attempted rung is recorded in
    ``policy.degrades``."""
    run = dict(executor=executor, torch_device=torch_device)
    if faults is None:
        return _run_factor(A, spec, nstreams, nbuf, validate, evict, plan,
                           **run)
    from repro_torch.fault.errors import OomError
    from repro_torch.fault.policy import FaultPolicy
    policy = policy or FaultPolicy()
    try:
        return _run_factor(A, spec, nstreams, nbuf, validate, evict, plan,
                           faults=faults, policy=policy, **run)
    except OomError as e:
        # without its traceback, whose frames hold the failed run's device
        # buffers until the re-run would have ended
        oom = e.with_traceback(None)
    obs = get_observability()
    n = A.shape[0]
    kernel = f"{kind}-factor"
    for step in policy.degrade_ladder(nbuf=nbuf, lookahead=spec.lookahead,
                                      budget_bytes=budget_bytes,
                                      tuned=tune == "auto"):
        policy.degrades.append(step)
        obs.instant(f"fault:degrade:{step.action}", kernel=kernel)
        try:
            if tune == "auto":
                spec2, ns2, nb2, ev2, plan2 = _tuned_factor_spec(
                    tuner, kind, n, panel, step.budget_bytes,
                    A.element_size(), A.dtype, torch_device)
            else:
                spec2 = _plan_factor_spec(
                    kind, n, panel, step.budget_bytes, A.element_size(),
                    step.lookahead, step.nbuf, torch_device)
                ns2, nb2, ev2, plan2 = nstreams, step.nbuf, evict, None
            result = _run_factor(A, spec2, ns2, nb2, validate, ev2, plan2,
                                 **run)
        except ValueError:
            continue
        obs.record_fault_recovery(kernel, "degrade")
        return result
    raise oom


def _check_square(A: torch.Tensor) -> int:
    n = A.shape[0]
    if A.dim() != 2 or tuple(A.shape) != (n, n):
        raise ValueError(f"square matrix required, got {tuple(A.shape)}")
    return n


def _prepare(A, backend, tune, devices, faults, executor,
             torch_device) -> Tuple[torch.Tensor, int, torch.device]:
    _check_slice(backend, tune, devices, faults)
    dev = _torch_device(executor, torch_device)
    A = host_tensor(A)
    return A, _check_square(A), dev


def _factor_spec(kind: str, A: torch.Tensor, n: int, panel: int,
                 budget_bytes: int, lookahead: int, nstreams: int, nbuf: int,
                 evict: str, tune, tuner, dev: torch.device):
    """(spec, nstreams, nbuf, evict, tuned plan or None) of an entry
    point's host pipeline: the tuner's, or the caller's knobs planned
    through :func:`_plan_factor_spec`."""
    if tune == "auto":
        return _tuned_factor_spec(tuner, kind, n, panel, budget_bytes,
                                  A.element_size(), A.dtype, dev)
    return (_plan_factor_spec(kind, n, panel, budget_bytes,
                              A.element_size(), lookahead, nbuf, dev),
            nstreams, nbuf, evict, None)


@_entry_call("cholesky")
def ooc_cholesky(A, panel: int = 256, *, budget_bytes: int,
                 backend: str = "host", tune=None, tuner=None,
                 lookahead: int = 1, nstreams: int = 2, nbuf: int = 2,
                 evict: str = "lru", validate: bool = False,
                 devices: Optional[Sequence] = None,
                 tolerance: Optional[float] = None,
                 faults=None, fault_policy=None,
                 executor: Optional[ScheduleExecutor] = None,
                 torch_device=None) -> torch.Tensor:
    """Lower-triangular Cholesky factor of SPD ``A`` (host-resident), as a
    CPU tensor in A's dtype.

    Host backend (default): the factorization is one lookahead pipeline
    schedule — panel POTRF/TRSM ops interleaved with the streamed SYRK
    trailing update; ``lookahead=0`` degenerates to the sequential
    per-panel loop.  ``evict`` picks the factored-row block cache's
    eviction policy (``"lru"``/``"belady"``) — it changes only H2D traffic,
    never the factor.

    ``tune="auto"`` resolves panel width, trailing block dims, stream
    count, buffer depth, lookahead and eviction policy from the autotuner
    (``tuner`` or the process default); on a card it searches at the
    budget less the panel ops' workspace (see the module docstring).

    ``backend="vmem"`` or ``devices=[...]`` takes the per-panel loop
    instead: panel ops on the device, the trailing update through
    :func:`~repro_torch.core.oocgemm.ooc_syrk` on that backend or across
    that device set (``tolerance`` as in ``ooc_syrk``).

    Precision: float64 input is computed in float32 and returned as
    float64 with f32-accurate residuals (~1e-6 relative, not LAPACK's
    ~1e-15), as in the reference.
    """
    obs = get_observability()
    with obs.span("cholesky.intake"):
        A, n, dev = _prepare(A, backend, tune, devices, faults, executor,
                             torch_device)
    if devices is not None or backend != "host":
        with prefer_cusolver(dev):
            return _loop_cholesky(A, panel, budget_bytes, backend, dev,
                                  tune, tuner, devices, tolerance)
    with obs.span("cholesky.plan"):
        spec, nstreams, nbuf, evict, plan = _factor_spec(
            "cholesky", A, n, panel, budget_bytes, lookahead, nstreams,
            nbuf, evict, tune, tuner, dev)
    out, _ = _run_factor_resilient(
        A, "cholesky", spec, nstreams, nbuf, validate, evict, plan,
        faults=faults, policy=fault_policy, panel=panel,
        budget_bytes=budget_bytes, executor=executor, torch_device=dev,
        tune=tune, tuner=tuner)
    # ``out`` is the run's own copy of A: masked where it lies
    with obs.span("cholesky.tril",
                  copy_bytes=n * (n - 1) // 2 * out.element_size()):
        return out.tril_()


@_entry_call("lu")
def ooc_lu(A, panel: int = 256, *, budget_bytes: int,
           backend: str = "host", tune=None, tuner=None,
           lookahead: int = 1, nstreams: int = 2, nbuf: int = 2,
           evict: str = "lru", validate: bool = False,
           devices: Optional[Sequence] = None,
           tolerance: Optional[float] = None,
           faults=None, fault_policy=None,
           executor: Optional[ScheduleExecutor] = None,
           torch_device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-looking LU with partial pivoting: ``A[perm] = L @ U``.

    Returns ``(LU, perm)`` as CPU tensors: ``LU`` (A's dtype) packs the
    unit-lower ``L`` below the diagonal and ``U`` on/above it; ``perm``
    (int64) is the row permutation such that ``A[perm]`` equals
    ``(tril(LU, -1) + I) @ triu(LU)``.

    Pivot search runs over the full resident panel (true partial pivoting:
    the panel holds every remaining row of its columns); row swaps replay on
    the host columns outside the panel at panel write-back
    (``lu_writeback`` handler), so the trailing stream always reads
    consistently permuted rows.  ``lookahead`` overlaps the next panel's
    transfer+GETRF with the current trailing update; ``tune="auto"``,
    ``backend="vmem"`` and ``devices=[...]`` behave as in
    :func:`ooc_cholesky`, with :func:`~repro_torch.core.oocgemm.ooc_gemm`
    as the loop's trailing update.  As there, float64 input is computed
    in float32.
    """
    obs = get_observability()
    with obs.span("lu.intake"):
        A, n, dev = _prepare(A, backend, tune, devices, faults, executor,
                             torch_device)
    if devices is not None or backend != "host":
        with prefer_cusolver(dev):
            return _loop_lu(A, panel, budget_bytes, backend, dev, tune,
                            tuner, devices, tolerance)
    with obs.span("lu.plan"):
        spec, nstreams, nbuf, evict, plan = _factor_spec(
            "lu", A, n, panel, budget_bytes, lookahead, nstreams, nbuf,
            evict, tune, tuner, dev)
    out, state = _run_factor_resilient(
        A, "lu", spec, nstreams, nbuf, validate, evict, plan,
        faults=faults, policy=fault_policy, panel=panel,
        budget_bytes=budget_bytes, executor=executor, torch_device=dev,
        tune=tune, tuner=tuner)
    return out, state.scratch.get("perm", torch.arange(n))


# ---------------------------------------------------------------------------
# Per-panel loop: the non-host backends and the hybrid device path (panel
# math on the device, trailing update through the out-of-core kernels)
# ---------------------------------------------------------------------------
def _trailing_kwargs(budget_bytes, backend, tune, tuner, dev, devices,
                     tolerance) -> dict:
    kw = dict(budget_bytes=budget_bytes, backend=backend, tune=tune,
              tuner=tuner, torch_device=dev)
    if devices is not None:
        kw.update(devices=devices, tolerance=tolerance)
    return kw


def _loop_cholesky(A: torch.Tensor, panel: int, budget_bytes: int,
                   backend: str, dev: torch.device, tune=None,
                   tuner=None, devices=None,
                   tolerance=None) -> torch.Tensor:
    A = A.clone()
    n = A.shape[0]
    kw = _trailing_kwargs(budget_bytes, backend, tune, tuner, dev, devices,
                          tolerance)
    infos: List[Tuple[str, torch.Tensor]] = []
    for k0 in range(0, n, panel):
        k1 = min(n, k0 + panel)
        d = k1 - k0
        pnl = device_tensor(A[k0:, k0:k1], dev)
        L, info = torch.linalg.cholesky_ex(pnl[:d, :d])
        pnl[:d, :d] = L
        infos.append((f"POTRF[{k0 // panel}]", info))
        chol_panel_solve(pnl)
        A[k0:, k0:k1] = pnl.cpu()
        if k1 == n:
            break
        # a hybrid update streams host operands: the panel just landed
        P = pnl[d:] if devices is None else A[k1:, k0:k1].contiguous()
        A[k1:, k1:] = ooc_syrk(P, A[k1:, k1:], alpha=-1.0, beta=1.0,
                               **kw).cpu()
    raise_on_info(infos)
    return A.tril_()


def _loop_lu(A: torch.Tensor, panel: int, budget_bytes: int, backend: str,
             dev: torch.device, tune=None, tuner=None, devices=None,
             tolerance=None) -> Tuple[torch.Tensor, torch.Tensor]:
    A = A.clone()
    n = A.shape[0]
    perm = torch.arange(n)
    kw = _trailing_kwargs(budget_bytes, backend, tune, tuner, dev, devices,
                          tolerance)
    for k0 in range(0, n, panel):
        k1 = min(n, k0 + panel)
        d = k1 - k0
        pnl = device_tensor(A[k0:, k0:k1], dev)
        piv = getrf_panel(pnl)
        apply_panel_pivots(A, piv, k0, k1, perm)
        A[k0:, k0:k1] = pnl.cpu()
        if k1 == n:
            break
        U = device_tensor(A[k0:k1, k1:], dev)
        lu_row_solve(pnl, U)
        A[k0:k1, k1:] = U.cpu()
        L, U = (pnl[d:], U) if devices is None else \
            (A[k1:, k0:k1].contiguous(), A[k0:k1, k1:].contiguous())
        A[k1:, k1:] = ooc_gemm(L, U, A[k1:, k1:], alpha=-1.0, beta=1.0,
                               **kw).cpu()
    return A, perm
