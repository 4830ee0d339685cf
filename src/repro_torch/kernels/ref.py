"""Plain PyTorch oracles for the port's kernels (ground truth in tests).

Port of ``src/repro/kernels/ref.py`` for the kernels of this slice; the
attention oracles come with ROADMAP kernel item 2.
"""

from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor, c=None, alpha: float = 1.0,
             beta: float = 0.0) -> torch.Tensor:
    """DGEMM contract: alpha * a @ b + beta * c, fp32 accumulation."""
    out = alpha * (a.float() @ b.float())
    if c is not None:
        out = out + beta * c.float()
    dtype = a.dtype if c is None else c.dtype
    return out.to(dtype)
