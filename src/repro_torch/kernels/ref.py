"""Plain PyTorch oracles for the port's kernels (ground truth in tests).

Port of ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor, c=None, alpha: float = 1.0,
             beta: float = 0.0) -> torch.Tensor:
    """DGEMM contract: alpha * a @ b + beta * c, fp32 accumulation."""
    out = alpha * (a.float() @ b.float())
    if c is not None:
        out = out + beta * c.float()
    dtype = a.dtype if c is None else c.dtype
    return out.to(dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length=None) -> torch.Tensor:
    """Single-token GQA attention oracle.

    q: (B, H, d); k, v: (B, S, Hkv, d); length: (B,) valid cache length
    (positions >= length are masked).  Returns (B, H, d) in q's dtype.
    """
    B, H, d = q.shape
    S, hkv = k.shape[1], k.shape[2]
    group = H // hkv
    kb = k.float().repeat_interleave(group, dim=2)   # (B, S, H, d)
    vb = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kb) / math.sqrt(d)
    if length is not None:
        lens = torch.as_tensor(length, device=q.device).reshape(B, 1, 1)
        s = torch.where(torch.arange(S, device=q.device)[None, None] < lens,
                        s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vb).to(q.dtype)


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal GQA attention oracle.

    q: (B, S, H, d); k, v: (B, S, Hkv, d).  Returns (B, S, H, d) in q's
    dtype.
    """
    B, S, H, d = q.shape
    group = H // k.shape[2]
    kb = k.float().repeat_interleave(group, dim=2)   # (B, S, H, d)
    vb = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb) / math.sqrt(d)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vb).to(q.dtype)
