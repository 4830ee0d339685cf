"""Block GEMM ``out = alpha * a @ b + beta * c``: wrapper, plain version and
launch counter of the hand-written Hopper kernel ``csrc/block_matmul.cu``.

Port of ``src/repro/kernels/block_matmul.py`` (the Pallas kernel
``_kernel`` and its wrapper ``block_matmul``), held against it and against
``kernels/ref.py`` by ``tests/test_torch_kernels.py``, and on the card by
``chip_smoke.py``.

What differs from the Pallas version, and why:

  * No host padding: the kernel masks ragged M/N/K edges itself and takes
    row strides, so a parity buffer view can be passed as it is.
  * ``block=`` is kept in the signature and validated, but the kernel has
    one CTA tile (128 x 128 x 8) and ignores it.  The result could not
    depend on it anyway: every output element is summed over k = 0..K-1
    in one fixed order.
  * ``out=`` lets the caller update a buffer in place (the executor's
    ``dgemm`` handler passes its C parity buffer); ``out`` may be ``c``.
  * Types: float32 (IEEE FMA, never TF32), bfloat16 and float16, all three
    operands alike; the sum is float32 and the output takes C's dtype.
    There is no float64 kernel: callers holding float64 host data compute
    in float32, as the reference does with JAX's 64-bit mode off.

On a CPU tensor the wrapper runs :func:`block_matmul_plain`; on a CUDA
tensor it launches the kernel or raises.  ``block_matmul.launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_c_void_p = ctypes.c_void_p
_c_ll = ctypes.c_longlong


def block_matmul_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                       alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same contract)."""
    return (alpha * (a.float() @ b.float()) + beta * c.float()).to(c.dtype)


def _check(a, b, c, out) -> None:
    ts = (a, b, c) if out is None else (a, b, c, out)
    if any(t.dim() != 2 for t in ts):
        raise ValueError("block_matmul takes 2-D tensors, got shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2 or tuple(c.shape) != (M, N) or (
            out is not None and tuple(out.shape) != (M, N)):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)} @ b {tuple(b.shape)} + c "
            f"{tuple(c.shape)}"
            + ("" if out is None else f" -> out {tuple(out.shape)}"))
    if any(t.device != a.device for t in ts):
        raise ValueError("block_matmul operands must share one device, got "
                         f"{[str(t.device) for t in ts]}")
    if a.dtype not in _DTYPE_CODE or any(t.dtype != a.dtype for t in ts):
        raise TypeError(
            "block_matmul takes float32, bfloat16 or float16 operands of one "
            f"dtype, got {[t.dtype for t in ts]}")
    for t in ts:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("block_matmul needs unit column stride (rows "
                             f"may be strided), got strides {t.stride()}")


def _check_block(block: Tuple[int, int, int]) -> None:
    if len(block) != 3 or any(int(x) < 1 for x in block):
        raise ValueError(f"block must be three positive ints, got {block!r}")


def block_matmul(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                 alpha: float = 1.0, beta: float = 0.0,
                 block: Tuple[int, int, int] = (512, 512, 512),
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * a @ b + beta * c`` into ``out`` (a new tensor if None).

    Shapes a (M, K), b (K, N), c and out (M, N); unit column stride, any
    row stride.  See the module docstring for types and ``block``.
    """
    _check(a, b, c, out)
    _check_block(block)
    if a.device.type == "cpu":
        res = block_matmul_plain(a, b, c, alpha=alpha, beta=beta)
        if out is None:
            return res
        out.copy_(res)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"block_matmul runs on cpu or cuda, not {a.device}")
    M, K = a.shape
    N = b.shape[1]
    if out is None:
        out = torch.empty((M, N), dtype=c.dtype, device=c.device)
    if M == 0 or N == 0:
        return out
    from repro_torch.kernels import _build

    fn = _build.load("block_matmul").repro_block_matmul
    if fn.argtypes is None:     # pointers and the stream as c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, _c_void_p, _c_void_p, _c_void_p,
                       _c_void_p, _c_ll, _c_ll, _c_ll, _c_ll, _c_ll, _c_ll,
                       _c_ll, ctypes.c_float, ctypes.c_float, _c_void_p]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), out.data_ptr(), M, N, K,
                 a.stride(0), b.stride(0), c.stride(0), out.stride(0),
                 float(alpha), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"block_matmul kernel launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, K={K}, dtype={a.dtype})")
    block_matmul.launches += 1
    return out


block_matmul.launches = 0
