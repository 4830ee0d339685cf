"""Hand-written backend-specific OOC GEMM implementations (no unified API).

Port of ``benchmarks/direct_impls.py``, held against it by
``tests/test_torch_direct.py`` and on the card by ``chip_smoke.py``.

These are the LOC denominator for claim C4 (75 % code reduction) and the
"direct" side of the abstraction-overhead comparison (C1): each
re-implements the out-of-core pipeline for ONE memory tier, managing its
own partitioning, buffers and ordering — the duplication the paper's
unified interface removes.

What "direct" means per tier, as in the reference: the host path
hand-derives its partition and op ordering (no partitioner, no
PipelineSpec, no event sets) but executes on the engine's shared
:class:`~repro_torch.core.runtime.ScheduleExecutor`, whose ``dgemm``
handler runs the library's block GEMM (kernel 1), so C1 measures the
planning and abstraction layers and not a second interpreter; the vmem path
is fully standalone: its own CUDA kernel (``csrc/direct_vmem_gemm.cu``,
kernel 3), ctypes binding and argument checks, all below, sharing nothing
with ``repro_torch.kernels`` but the build helper ``_build``; the mesh
path is a standalone SUMMA ring over ``torch.distributed`` point-to-point
calls with its own sharding and ring bookkeeping, whose block products are
the library's block GEMM (kernel 1, as the host path's), so on the same
ranks it equals the MESH tier bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.runtime import (ScheduleExecutor, as_tensor,
                                      block_gemm, host_tensor,
                                      resolve_device)
from repro_torch.core.streams import (BlockRef, Device, Op, OpKind, Schedule,
                                      SliceRef, StreamFactory)
from repro_torch.kernels import _build


# ===========================================================================
# 1. host-tier direct implementation (HBM streaming, manual double buffer)
# ===========================================================================
def direct_host_ooc_gemm(A, B, C, alpha, beta, budget_bytes, *,
                         torch_device=None,
                         executor: Optional[ScheduleExecutor] = None
                         ) -> torch.Tensor:
    """Hand-rolled host-driven block streaming: inline partitioning and a
    hand-built serial op list — no partitioner, no PipelineSpec, no event
    sets.  Execution dispatches through the shared ScheduleExecutor (the one
    schedule interpreter in the engine); what stays "direct" here is
    everything the library would otherwise derive.

    Host data in (numpy arrays or CPU tensors), a CPU tensor out.  A new
    ``ScheduleExecutor(async_writeback=True)`` runs it on ``torch_device``
    (default: CUDA), unless the caller passes ``executor`` (to read its byte
    counters, say)."""
    if executor is None:
        executor = ScheduleExecutor(async_writeback=True,
                                    torch_device=torch_device)
    A = host_tensor(A)
    B = host_tensor(B)
    out = host_tensor(C).clone()
    M, K = A.shape
    _, N = B.shape
    bpe = A.element_size()

    # inline partitioning: shrink block dims until 2 A-slices + B-slice +
    # 2 C-blocks fit the budget, keeping alignment by hand
    bm, bn = M, N
    def ws(bm, bn):
        return (2 * bm * K + K * bn + 2 * bm * bn) * bpe
    while ws(bm, bn) > budget_bytes:
        if bm >= bn and bm > 8:
            bm = max(8, (bm // 2 + 7) // 8 * 8)
        elif bn > 128:
            bn = max(128, (bn // 2 + 127) // 128 * 128)
        elif bm > 8:
            bm = max(8, (bm // 2 + 7) // 8 * 8)
        else:
            raise ValueError("cannot fit budget")
    h = math.ceil(M / bm)
    w = math.ceil(N / bn)

    # hand-built single-stream op list: ping-pong parities, B reused per
    # column, no events (issue order is the only dependency structure)
    dev = Device("HBM", 0, budget_bytes)
    sched = Schedule(dev, StreamFactory.create(dev, 1))
    idx = 0
    for j in range(w):
        cs, cn = j * bn, min(bn, N - j * bn)
        sched.issue(Op(kind=OpKind.H2D, tag=f"S(b[{j}])", stream=0,
                       buffers_written=(("B", j % 2),), bytes=K * cn * bpe,
                       payload=SliceRef("B", j, cols=(cs, cn))))
        for i in range(h):
            rs, rn = i * bm, min(bm, M - i * bm)
            p = idx % 2
            sched.issue(Op(kind=OpKind.H2D, tag=f"S(a[{idx}])", stream=0,
                           buffers_written=(("A", p),), bytes=rn * K * bpe,
                           payload=SliceRef("A", idx, rows=(rs, rn))))
            sched.issue(Op(kind=OpKind.H2D, tag=f"S(c[{idx}])", stream=0,
                           buffers_written=(("C", p),), bytes=rn * cn * bpe,
                           payload=SliceRef("C", idx, rows=(rs, rn),
                                            cols=(cs, cn))))
            sched.issue(Op(kind=OpKind.COMPUTE, tag=f"DGEMM[{idx}]", stream=0,
                           buffers_read=(("A", p), ("B", j % 2)),
                           buffers_written=(("C", p),),
                           flops=2 * rn * cn * K,
                           payload=BlockRef("dgemm", idx)))
            sched.issue(Op(kind=OpKind.D2H, tag=f"R(c[{idx}])", stream=0,
                           buffers_read=(("C", p),), bytes=rn * cn * bpe,
                           payload=SliceRef("C", idx, rows=(rs, rn),
                                            cols=(cs, cn))))
            idx += 1
    executor.run(sched, operands={"A": A, "B": B}, outputs={"C": out},
                 ctx={"alpha": alpha, "beta": beta})
    return out


# ===========================================================================
# 2. vmem-tier direct implementation (hand-written Hopper kernel)
# ===========================================================================
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def direct_vmem_ooc_gemm_plain(A: torch.Tensor, B: torch.Tensor,
                               C: torch.Tensor, alpha: float,
                               beta: float) -> torch.Tensor:
    """The plain PyTorch version of kernel 3: ``alpha * A @ B + beta * C``
    summed in float32, the result in C's dtype."""
    return (alpha * (A.float() @ B.float()) + beta * C.float()).to(C.dtype)


def direct_vmem_ooc_gemm(A, B, C, alpha, beta,
                         block: Tuple[int, int, int] = (256, 256, 256), *,
                         torch_device=None) -> torch.Tensor:
    """Standalone hand-written kernel (no kernels/ reuse): its own grid,
    tiling, masking and binding.  One launch of ``csrc/direct_vmem_gemm.cu``
    on operands on ``torch_device`` (default: CUDA; operands elsewhere are
    moved there); with ``torch_device="cpu"`` the plain version runs.

    Returns a new (M, N) tensor in C's dtype; ``C`` is left unchanged.
    Operands share one dtype: float32 (IEEE FMA on the CUDA cores, never
    TF32), bfloat16 or float16 (the tensor cores, f32 accumulator; an
    ml_dtypes ``bfloat16`` array is taken too); float64 is computed in
    float32, as the reference does with JAX's 64-bit mode off.  Inputs need
    unit column stride and may have any row stride; nothing is copied to fix
    a layout.

    ``block`` is the (bm, bn, bk) tile the caller asks for.  The reference
    pads to it; here it is checked and ignored: the kernel has one CTA tile
    (128 x 256) and one k step for each dtype (16 in f32, one m64n256k16
    instruction in 16 bits), which are kernel 1's.  Every output element is
    summed over k in one fixed order, so the result does not depend on
    ``block``.  ``direct_vmem_ooc_gemm.launches`` counts kernel launches,
    and ``direct_vmem_ooc_gemm.launches_by_dtype`` counts them by dtype name.
    """
    dev = resolve_device(torch_device)
    ts = []
    for x in (A, B, C):
        t = as_tensor(x)
        if t.dtype == torch.float64:
            t = t.float()
        ts.append(t.to(dev))
    A, B, C = ts
    if any(t.dim() != 2 for t in ts):
        raise ValueError("direct_vmem_ooc_gemm takes 2-D operands, got "
                         f"{[tuple(t.shape) for t in ts]}")
    M, K = A.shape
    N = B.shape[1]
    if B.shape[0] != K or tuple(C.shape) != (M, N):
        raise ValueError(f"shape mismatch: A {tuple(A.shape)} @ B "
                         f"{tuple(B.shape)} + C {tuple(C.shape)}")
    if A.dtype not in _DTYPE_CODE or any(t.dtype != A.dtype for t in ts):
        raise TypeError("direct_vmem_ooc_gemm takes float32, bfloat16 or "
                        "float16 operands of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if len(block) != 3 or any(int(b) < 1 for b in block):
        raise ValueError(f"block must be three positive ints, got {block!r}")
    for t in ts:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("direct_vmem_ooc_gemm needs unit column stride "
                             f"(rows may be strided), got {t.stride()}")
    if dev.type == "cpu":
        return direct_vmem_ooc_gemm_plain(A, B, C, alpha, beta)
    out = torch.empty((M, N), dtype=C.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    fn = _build.load("direct_vmem_gemm").repro_direct_vmem_gemm
    if fn.argtypes is None:     # pointers and the stream as c_void_p
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, ctypes.c_float, vp]
    with torch.cuda.device(dev):
        err = fn(_DTYPE_CODE[A.dtype], A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), out.data_ptr(), M, N, K, A.stride(0),
                 B.stride(0), C.stride(0), float(alpha), float(beta),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"direct_vmem_gemm launch failed: CUDA error {err}"
                           f" (M={M}, N={N}, K={K}, dtype={A.dtype})")
    direct_vmem_ooc_gemm.launches += 1
    by_dtype = direct_vmem_ooc_gemm.launches_by_dtype
    by_dtype[str(A.dtype)[6:]] = by_dtype.get(str(A.dtype)[6:], 0) + 1
    return out


direct_vmem_ooc_gemm.launches = 0
direct_vmem_ooc_gemm.launches_by_dtype = {}


# ===========================================================================
# 3. mesh-tier direct implementation (hand-written SUMMA ring)
# ===========================================================================
def direct_mesh_ooc_gemm(A, B, C, alpha, beta, mesh, axis="model"):
    """Standalone SUMMA ring with its own bookkeeping: this rank's row
    blocks of A and C and column block of B, the B blocks passed around
    the ranks of ``mesh[axis]`` with isend/irecv issued before each block
    product.  Every rank passes the full operands; C comes back as a
    DTensor sharded by rows."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    ring = mesh[axis] if mesh.ndim > 1 else mesh
    Pn, me, group = ring.size(), ring.get_local_rank(), ring.get_group()
    dev = resolve_device(mesh.device_type)
    A, B, C = (as_tensor(x) for x in (A, B, C))
    M, K = A.shape
    N = B.shape[1]
    assert M % Pn == 0 and N % Pn == 0
    mb, nb = M // Pn, N // Pn
    a = A[me * mb:(me + 1) * mb].to(dev).contiguous()
    b = B[:, me * nb:(me + 1) * nb].to(dev).contiguous()
    acc = C[me * mb:(me + 1) * mb].to(dev).clone()
    spare = torch.empty_like(b)
    dst = dist.get_global_rank(group, (me - 1) % Pn)
    src = dist.get_global_rank(group, (me + 1) % Pn)
    for t in range(Pn):
        reqs = []
        if t < Pn - 1:
            reqs = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, b, dst, group),
                 dist.P2POp(dist.irecv, spare, src, group)])
        col = ((me + t) % Pn) * nb
        view = acc[:, col:col + nb]
        block_gemm(a, b, view, alpha=alpha, beta=beta, out=view)
        for r in reqs:
            r.wait()
        b, spare = spare, b
    return DTensor.from_local(acc, ring, (Shard(0),), run_check=False)
