"""Calibration: measure the machine, don't hand-enter it.

Port of ``src/repro/tune/calibrate.py``, held against it by
``tests/test_torch_tune.py`` and on the card by ``chip_smoke.py``.
:class:`HardwareProfile`, its :meth:`~HardwareProfile.model_for` and the
canned :func:`gpu_profile`, :func:`phi_profile` and :func:`tpu_v5e_profile`
are copies: simulation inputs transcribed from the paper and data sheets,
not measurements of any card.  What is the port's own is the measuring:

  * :func:`calibrate` times one-op schedules through the port's
    :class:`~repro_torch.core.runtime.ScheduleExecutor` with
    ``record_spans=True`` on the calibrating device (``torch_device``,
    CUDA unless the caller names the CPU): H2D and D2H slices at two sizes
    (a two-point fit separates per-op overhead from bandwidth) and one
    ``dgemm`` block through the registered handler, kernel 1 on a card, as
    in production.  On a card the spans are CUDA events around each op's
    device work, so an H2D span is the copy engine's time from pinned
    staging (the host's staging fill is outside it).
  * :func:`hardware_fingerprint` hashes the platform, the device's type
    and, on CUDA, its name, SM count and memory and the card count, with
    the torch, CUDA and numpy versions — the backend's identity, never a
    measured rate — so plan-cache keys are stable across runs on the same
    machine and change with the hardware or the libraries.

A profile records one compute rate, timed in float32: a plan for 16-bit
operands is ranked as if kernel 1 ran at its f32 rate, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import platform as _platform
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.runtime import ScheduleExecutor, resolve_device
from repro_torch.core.simulator import HardwareModel
from repro_torch.core.streams import (BlockRef, Device, Op, OpKind, Schedule,
                                      SliceRef, StreamFactory)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Measured (or transcribed) rates plus engine topology.

    ``shared_transfer``: one engine serves both directions (Phi's offload
    path) instead of independent H2D/D2H copy engines (CUDA GPUs).
    ``shared_compute``: offload streams split the core's threads, so the
    aggregate compute rate is divided across streams at
    ``split_efficiency`` (the paper measures 549/725 ~= 0.76 on Phi 3120P
    with 2 streams) — the mechanism behind claim C5.
    """

    name: str
    h2d_bw: float                    # bytes/s
    d2h_bw: float
    flops: float                     # sustained in-core flop/s
    per_op_overhead: float = 2e-6    # s (launch/abstraction cost, claim C1)
    shared_transfer: bool = False
    shared_compute: bool = False
    split_efficiency: float = 1.0

    def model_for(self, nstreams: int = 2) -> HardwareModel:
        """Concrete engine model for a candidate stream count."""
        if nstreams < 1:
            raise ValueError("nstreams must be >= 1")
        if self.shared_transfer:
            pools = {"xfer": 1,
                     "exec": nstreams if self.shared_compute else 1}
            kind_pool = {OpKind.H2D: "xfer", OpKind.D2H: "xfer",
                         OpKind.COMPUTE: "exec"}
        else:
            pools = {"h2d": 1, "d2h": 1, "exec": 1}
            kind_pool = {OpKind.H2D: "h2d", OpKind.D2H: "d2h",
                         OpKind.COMPUTE: "exec"}
        split = nstreams if self.shared_compute else 1
        return HardwareModel(
            name=f"{self.name}-s{nstreams}",
            pools=pools,
            kind_pool=kind_pool,
            h2d_bw=self.h2d_bw,
            d2h_bw=self.d2h_bw,
            flops=self.flops,
            per_op_overhead=self.per_op_overhead,
            compute_split=split,
            split_efficiency=1.0 if split == 1 else self.split_efficiency,
        )


# --------------------------------------------------------------------------
# Canned profiles (the paper's hardware, for simulation studies and tests)
# --------------------------------------------------------------------------
def gpu_profile(flops: float = 1.16e12, pcie: float = 11e9) -> HardwareProfile:
    """K40c-like: independent copy engines, dedicated kernel engine."""
    return HardwareProfile(name="gpu-like", h2d_bw=pcie, d2h_bw=pcie,
                           flops=flops)


def phi_profile(flops: float = 0.725e12,
                pcie: float = 6.5e9) -> HardwareProfile:
    """Xeon Phi 3120P-like: shared transfer engine, thread-split compute."""
    return HardwareProfile(name="phi-like", h2d_bw=pcie, d2h_bw=pcie,
                           flops=flops, shared_transfer=True,
                           shared_compute=True, split_efficiency=0.76)


def tpu_v5e_profile() -> HardwareProfile:
    """TPU v5e VMEM tier: separate in/out DMA queues, pipelined descriptors
    (the reference's data-sheet figures, a simulation input only)."""
    return HardwareProfile(name="tpu-v5e-vmem", h2d_bw=819e9, d2h_bw=819e9,
                           flops=197e12, per_op_overhead=5e-8)


# --------------------------------------------------------------------------
# Fingerprint
# --------------------------------------------------------------------------
def hardware_fingerprint(torch_device=None) -> str:
    """Stable identity of the calibrating backend for plan-cache keys.

    Hashes platform facts, not measurements: the same machine must produce
    the same fingerprint every run, or every run would re-search.  16 hex
    characters."""
    dev = resolve_device(torch_device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        kind = (props.name, str(props.multi_processor_count),
                str(props.total_memory))
        count = torch.cuda.device_count()
    else:
        kind, count = ("cpu",), 1
    parts = (
        _platform.system(),
        _platform.machine(),
        dev.type,
        *kind,
        str(count),
        torch.__version__,
        str(torch.version.cuda),
        np.__version__,
    )
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Micro-benchmarks through the ScheduleExecutor
# --------------------------------------------------------------------------
def _one_op_schedule(ops) -> Schedule:
    dev = Device("HBM", 0, 1 << 30)
    n = max(op.stream for op in ops) + 1
    sched = Schedule(dev, StreamFactory.create(dev, n))
    for op in ops:
        sched.issue(op)
    return sched


def _min_span(spans, tag_prefix: str) -> float:
    ts = [e - s for tag, _, s, e in spans if tag.startswith(tag_prefix)]
    if not ts:
        raise RuntimeError(f"no spans tagged {tag_prefix!r}")
    return min(ts)


def _h2d(tag: str, name: str, nbytes: int, rows=None) -> Op:
    return Op(kind=OpKind.H2D, tag=tag, stream=0,
              buffers_written=((name, 0),), bytes=nbytes,
              payload=SliceRef(name, 0, rows=rows))


def _time_h2d(rows: int, cols: int, repeats: int,
              dev: torch.device) -> float:
    """Best-of-``repeats`` seconds to land one (rows x cols) f32 slice on
    ``dev``, measured as an executor H2D span."""
    X = np.ones((rows, cols), dtype=np.float32)
    ex = ScheduleExecutor(record_spans=True, torch_device=dev)
    sched = _one_op_schedule([_h2d("S(x[0])", "X", X.nbytes, (0, rows))])
    best = np.inf
    for _ in range(repeats):
        ex.run(sched, operands={"X": X}, outputs={})
        best = min(best, _min_span(ex.last_spans, "S("))
    return best


def _time_d2h(rows: int, cols: int, repeats: int,
              dev: torch.device) -> float:
    """Best-of-``repeats`` seconds to bring one slice back to host memory
    (synchronous write-back, so the span covers the materialization)."""
    X = np.ones((rows, cols), dtype=np.float32)
    out = np.zeros_like(X)
    ex = ScheduleExecutor(record_spans=True, async_writeback=False,
                          torch_device=dev)
    sched = _one_op_schedule([
        _h2d("S(x[0])", "X", X.nbytes, (0, rows)),
        Op(kind=OpKind.D2H, tag="R(x[0])", stream=0,
           buffers_read=(("X", 0),),
           bytes=X.nbytes, payload=SliceRef("X", 0, rows=(0, rows))),
    ])
    best = np.inf
    for _ in range(repeats):
        ex.run(sched, operands={"X": X}, outputs={"X": out})
        best = min(best, _min_span(ex.last_spans, "R("))
    return best


def _time_dgemm(n: int, repeats: int, dev: torch.device) -> float:
    """Best-of-``repeats`` seconds for one n x n x n f32 ``dgemm`` block
    through the registered handler (the same op production schedules
    dispatch: kernel 1 on a card)."""
    A = np.ones((n, n), dtype=np.float32)
    B = np.ones((n, n), dtype=np.float32)
    C = np.zeros((n, n), dtype=np.float32)
    ex = ScheduleExecutor(record_spans=True, torch_device=dev)
    sched = _one_op_schedule([
        _h2d("S(a[0])", "A", A.nbytes),
        _h2d("S(b[0])", "B", B.nbytes),
        _h2d("S(c[0])", "C", C.nbytes),
        Op(kind=OpKind.COMPUTE, tag="DGEMM[0]", stream=0,
           buffers_read=(("A", 0), ("B", 0)),
           buffers_written=(("C", 0),),
           flops=2 * n**3 + 3 * n**2,
           payload=BlockRef(kernel="dgemm", index=0)),
    ])
    best = np.inf
    for _ in range(repeats):
        ex.run(sched, operands={"A": A, "B": B},
               outputs={"C": C.copy()},
               ctx={"alpha": 1.0, "beta": 0.0})
        best = min(best, _min_span(ex.last_spans, "DGEMM"))
    return best


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    profile: HardwareProfile
    fingerprint: str
    samples: Dict[str, float]        # raw best-of-N measurements


# the micro-benchmarks' sizes by device type: on the CPU the reference's
# (1 MiB and 8 MiB f32 transfers, a 512^3 dgemm); on a card 8 MiB and
# 128 MiB transfers (past the copy engines' start-up cost) and a 4096^3
# dgemm (512 of kernel 1's 128x256 tiles, ~4 waves over an H100's 132
# SMs; a 512^3 block launches 8 CTAs and would rank the card as
# compute-bound)
DEFAULTS = {
    "cpu": {"small": (256, 1024), "large": (2048, 1024), "gemm_n": 512},
    "cuda": {"small": (2048, 1024), "large": (32768, 1024), "gemm_n": 4096},
}


def calibrate(tier: str = "HBM",
              small: Optional[Tuple[int, int]] = None,
              large: Optional[Tuple[int, int]] = None,
              gemm_n: Optional[int] = None,
              repeats: int = 3,
              torch_device=None) -> CalibrationResult:
    """Fit a :class:`HardwareProfile` for ``torch_device`` (default: the
    card).

    Transfers are timed at two sizes and solved as ``t = overhead +
    bytes/bw`` (two-point fit, best-of-``repeats`` to suppress scheduler
    noise); compute from one timed ``dgemm`` block.  ``small``/``large``
    (f32 slice shapes) and ``gemm_n`` default to :data:`DEFAULTS` for the
    device's type: the reference's sizes on the CPU; on a card 8 MiB and
    128 MiB transfers and ``gemm_n = 4096``.  Topology: H2D, D2H and
    compute run on independent engines (a card's two copy engines and its
    SMs), the gpu-like triple; the shared-engine topologies remain
    available as canned profiles for simulation studies.
    """
    dev = resolve_device(torch_device)
    sizes = DEFAULTS[dev.type]
    small = tuple(small or sizes["small"])
    large = tuple(large or sizes["large"])
    gemm_n = gemm_n or sizes["gemm_n"]
    small_b = small[0] * small[1] * 4
    large_b = large[0] * large[1] * 4
    if large_b <= small_b:
        raise ValueError("large transfer must exceed small transfer")

    t_h2d_s = _time_h2d(*small, repeats, dev)
    t_h2d_l = _time_h2d(*large, repeats, dev)
    t_d2h_s = _time_d2h(*small, repeats, dev)
    t_d2h_l = _time_d2h(*large, repeats, dev)
    t_gemm = _time_dgemm(gemm_n, repeats, dev)

    def fit(t_s: float, t_l: float) -> Tuple[float, float]:
        dt = max(t_l - t_s, 1e-9)
        bw = (large_b - small_b) / dt
        overhead = max(t_s - small_b / bw, 1e-8)
        return bw, overhead

    h2d_bw, oh_h2d = fit(t_h2d_s, t_h2d_l)
    d2h_bw, oh_d2h = fit(t_d2h_s, t_d2h_l)
    gemm_flops = 2 * gemm_n**3 + 3 * gemm_n**2
    flops = gemm_flops / max(t_gemm, 1e-9)

    profile = HardwareProfile(
        name=f"calibrated-{tier.lower()}",
        h2d_bw=h2d_bw,
        d2h_bw=d2h_bw,
        flops=flops,
        per_op_overhead=float(np.clip((oh_h2d + oh_d2h) / 2, 1e-8, 1e-3)),
    )
    return CalibrationResult(
        profile=profile,
        fingerprint=hardware_fingerprint(dev),
        samples={
            "h2d_small_s": t_h2d_s, "h2d_large_s": t_h2d_l,
            "d2h_small_s": t_d2h_s, "d2h_large_s": t_d2h_l,
            f"dgemm_{gemm_n}_s": t_gemm,
        },
    )
