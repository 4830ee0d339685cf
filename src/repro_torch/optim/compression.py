"""int8 gradient compression with error feedback.

Port of ``src/repro/optim/compression.py``: per-tensor symmetric int8
quantization, and its error-feedback form over a dict of gradients (the
quantization residual is carried to the next step, which keeps the applied
gradient unbiased in the long run; Karimireddy et al., 2019).  Wire cost:
1 byte an element plus one f32 scale a tensor.

``compressed_pod_psum``, the cross-pod reduction with a shared scale, runs
only inside a collective over the pod axis: ROADMAP module item 13.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def compressed_pod_psum(grads, error, axis_name: str = "pod"):
    """The mean gradient across pods, int8 on the wire with a shared scale
    and error feedback.  It needs the pod axis of a device mesh, which the
    port does not have yet."""
    raise NotImplementedError(
        "compressed_pod_psum runs inside a collective over the pod axis: "
        "ROADMAP module item 13 (distribution) ports it")
