"""MMOOC — out-of-core matrix multiplication, the paper's reference kernel.

Port of ``src/repro/core/oocgemm.py``, held against it by
``tests/test_torch_oocgemm.py`` and on the card by ``chip_smoke.py``.

``ooc_gemm`` plans a partition for the memory budget, builds the
event-correct pipeline schedule and executes it on the selected backend.
If the whole problem fits the budget, one in-core launch of the block GEMM
is issued instead (the paper's C2 transition).  Unlike the reference, whose
in-core path is XLA's dot, every path here runs the one hand-written
kernel, so the host, in-core and vmem results agree bit for bit.

``torch_device`` (default: CUDA) selects where blocks are computed; with
no card the caller must pass ``torch_device="cpu"`` (the kernels' plain
versions).  The host backend takes and returns host data (numpy arrays or
CPU tensors in, a CPU tensor out); the vmem backend moves its operands to
the device and returns a device tensor.

Not in this slice: ``tune="auto"`` (ROADMAP module item 7), ``devices=``
(item 8), ``faults=``/``fault_policy=`` (item 6) and ``backend="mesh"``
(item 10); each raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import pipeline as plib
from repro_torch.core.partitioner import GemmPartition, plan_gemm_partition
from repro_torch.core.runtime import (HostOocRuntime, OocRuntime,
                                      VmemOocRuntime, device_tensor,
                                      host_tensor, not_ported,
                                      resolve_device)
from repro_torch.core.streams import Device, validate_schedule
from repro_torch.kernels import ops as kops


def is_in_core(M: int, N: int, K: int, budget_bytes: int,
               bytes_per_el: int = 4) -> bool:
    """True if A, B and C are simultaneously resident within the budget."""
    return (M * K + K * N + M * N) * bytes_per_el <= budget_bytes


def _check_slice(backend: str, tune, devices, faults, fault_policy) -> None:
    if tune not in (None, "auto"):
        raise ValueError(f"unknown tune mode {tune!r}; expected None/'auto'")
    if tune == "auto":
        raise not_ported("tune")
    if devices is not None:
        raise not_ported("devices")
    if faults is not None or fault_policy is not None:
        raise not_ported("faults")
    if backend == "mesh":
        raise not_ported("MESH")
    if backend not in ("host", "vmem"):
        raise ValueError(f"unknown backend {backend!r}")


def _torch_device(runtime: Optional[OocRuntime], torch_device
                  ) -> torch.device:
    if runtime is None:
        return resolve_device(torch_device)
    if torch_device is not None \
            and resolve_device(torch_device) != runtime.torch_device:
        raise ValueError(f"torch_device {torch_device} differs from the "
                         f"runtime's {runtime.torch_device}")
    return runtime.torch_device


def _operand(x, backend: str, dev: torch.device) -> torch.Tensor:
    return host_tensor(x) if backend == "host" else device_tensor(x, dev)


def _in_core(A, B, C, alpha, beta, backend: str, dev: torch.device
             ) -> torch.Tensor:
    """One resident launch of the block GEMM (claim C2 transition point)."""
    out = kops.block_matmul(device_tensor(A, dev), device_tensor(B, dev),
                            device_tensor(C, dev), alpha=alpha, beta=beta)
    return out.cpu() if backend == "host" else out


def ooc_gemm(
    A,
    B,
    C=None,
    alpha: float = 1.0,
    beta: float = 0.0,
    *,
    budget_bytes: int,
    backend: str = "host",
    nstreams: int = 2,
    nbuf: int = 2,
    traversal: str = "col",
    evict: str = "lru",
    validate: bool = False,
    runtime: Optional[OocRuntime] = None,
    tune: Optional[str] = None,
    devices: Optional[Sequence] = None,
    faults=None,
    fault_policy=None,
    torch_device=None,
) -> torch.Tensor:
    """Compute ``alpha * A @ B + beta * C`` streaming blocks through a memory
    tier of size ``budget_bytes``.

    backend: "host" (schedule-driven block streaming from host memory) or
    "vmem" (one launch of the block GEMM on device-resident operands).

    traversal / evict (host backend): block-grid step order and
    residency-cache eviction policy — they change which H2D transfers the
    compiler's block cache elides, never the result.

    runtime: a prepared :class:`HostOocRuntime` / :class:`VmemOocRuntime`
    (for instance one whose executor runs ``mode="concurrent"``); its torch
    device is used.
    """
    _check_slice(backend, tune, devices, faults, fault_policy)
    dev = _torch_device(runtime, torch_device)
    A = _operand(A, backend, dev)
    B = _operand(B, backend, dev)
    M, K = A.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"inner dims mismatch: {tuple(A.shape)} @ "
                         f"{tuple(B.shape)}")
    if C is None:
        C = torch.zeros((M, N), dtype=A.dtype, device=A.device)
        beta = 0.0
    bpe = A.element_size()

    if is_in_core(M, N, K, budget_bytes, bpe):
        return _in_core(A, B, C, alpha, beta, backend, dev)

    part = plan_gemm_partition(M, N, K, budget_bytes, bpe)
    if backend == "host":
        sched = plib.build_gemm_schedule(part, nstreams=nstreams, nbuf=nbuf,
                                         traversal=traversal, evict=evict)
        if validate:
            validate_schedule(sched)
        rt = runtime or HostOocRuntime(Device("HBM", 0, budget_bytes),
                                       torch_device=dev)
        return rt.gemm(A, B, C, alpha, beta, part, schedule=sched)
    rt = runtime or VmemOocRuntime(Device("VMEM", 0, budget_bytes),
                                   torch_device=dev)
    return rt.gemm(A, B, C, alpha, beta, part)


def ooc_syrk(
    P,
    C=None,
    alpha: float = 1.0,
    beta: float = 0.0,
    *,
    budget_bytes: int,
    backend: str = "host",
    nstreams: int = 2,
    nbuf: int = 2,
    traversal: str = "col",
    evict: str = "lru",
    validate: bool = False,
    runtime: Optional[OocRuntime] = None,
    tune: Optional[str] = None,
    devices: Optional[Sequence] = None,
    faults=None,
    fault_policy=None,
    torch_device=None,
) -> torch.Tensor:
    """Compute ``alpha * P @ P^T + beta * C`` out-of-core (blocked SYRK).

    On the host backend the SYRK pipeline spec streams the panel twice (row
    slices and transposed row slices) through the same schedule shape and
    ``dgemm`` handler as MMOOC; only individual blocks are transposed, on
    the host, into staging.  The vmem and in-core paths materialize
    ``P^T`` on the device and run the dense block GEMM.
    """
    _check_slice(backend, tune, devices, faults, fault_policy)
    dev = _torch_device(runtime, torch_device)
    P = _operand(P, backend, dev)
    n, K = P.shape
    if C is None:
        C = torch.zeros((n, n), dtype=P.dtype, device=P.device)
        beta = 0.0
    bpe = P.element_size()

    if is_in_core(n, n, K, budget_bytes, bpe):
        Pd = device_tensor(P, dev)
        return _in_core(Pd, Pd.T.contiguous(), C, alpha, beta, backend, dev)

    part = plan_gemm_partition(n, n, K, budget_bytes, bpe)
    if backend == "host":
        sched = plib.build_syrk_schedule(part, nstreams=nstreams, nbuf=nbuf,
                                         traversal=traversal, evict=evict)
        if validate:
            validate_schedule(sched)
        rt = runtime or HostOocRuntime(Device("HBM", 0, budget_bytes),
                                       torch_device=dev)
        return rt.syrk(P, C, alpha, beta, part, schedule=sched)
    rt = runtime or VmemOocRuntime(Device("VMEM", 0, budget_bytes),
                                   torch_device=dev)
    return rt.gemm(P, P.T.contiguous(), C, alpha, beta, part)


def plan_for_device(M: int, N: int, K: int, device: Device,
                    bytes_per_el: int = 4) -> GemmPartition:
    """Partition using the device's reported memory (hclGetMemSize path)."""
    return plan_gemm_partition(M, N, K, device.mem_bytes, bytes_per_el)
