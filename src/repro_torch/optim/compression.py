"""int8 gradient compression with error feedback.

Port of ``src/repro/optim/compression.py``: per-tensor symmetric int8
quantization, and its error-feedback form over a dict of gradients (the
quantization residual is carried to the next step, which keeps the applied
gradient unbiased in the long run; Karimireddy et al., 2019).  Wire cost:
1 byte an element plus one f32 scale a tensor.

:func:`compressed_pod_psum` is the cross-pod reduction with a shared
scale, over the ranks of a device mesh's ``"pod"`` axis: the reference's
``pmax`` is an ``all_reduce(MAX)`` and its ``psum`` an ``all_reduce(SUM)``.
The int8 payloads are summed as int32 on the wire: NCCL has no int16
reduction, and an int32 sum of int8 values is exactly the reference's
int16 sum (|sum| <= 127 * 256 < 2^15 for up to 256 pods).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization.  Returns (q, scale), the
    scale a 0-dim float32 tensor."""
    g32 = g.float()
    scale = g32.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads: Tensors, error: Tensors
                ) -> Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                           Dict[str, torch.Tensor]]:
    """Error-feedback compression of a dict of gradients: each gradient
    plus its carried error is quantized.  Returns ({name: (q, scale)},
    {name: new error})."""
    comp, errs = {}, {}
    for k, g in grads.items():
        corrected = g.float() + error[k]
        q, s = quantize(corrected)
        comp[k] = (q, s)
        errs[k] = corrected - dequantize(q, s)
    return comp, errs


def init_error(params: Tensors) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_pod_psum(grads: Tensors, error: Tensors, mesh,
                        axis_name: str = "pod", stats: Optional[dict] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """The mean gradient across the ranks of ``mesh[axis_name]`` (a
    ``DeviceMesh``; one rank a pod), int8 on the wire with a shared scale
    and error feedback.  ``grads`` and ``error`` are this rank's tensors by
    name.  The shared scale is the largest of the pods' scales (one scalar
    ``all_reduce(MAX)``), so the dequantized sum is exact up to
    quantization: sum_i q_i s = s sum_i q_i.  Returns ({name: mean
    gradient}, {name: new error}); given a dict, ``stats["q"]`` receives
    each tensor's int8 payload."""
    import torch.distributed as dist

    group = (mesh[axis_name] if mesh.ndim > 1 else mesh).get_group()
    npods = float(dist.get_world_size(group))
    deq, errs, payloads = {}, {}, {}
    for k, g in grads.items():
        corrected = g.float() + error[k]
        s = corrected.abs().max() / 127.0 + 1e-12
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(corrected / s), -127, 127).to(
            torch.int8)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        deq[k] = qsum.float() * s / npods
        errs[k] = corrected - q.float() * s
        payloads[k] = q
    if stats is not None:
        stats["q"] = payloads
    return deq, errs
