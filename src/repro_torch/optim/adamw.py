"""AdamW with global-norm clipping and an f32 master copy.

Port of ``src/repro/optim/adamw.py``.  The reference's functions over
pytrees become functions over dicts of tensors keyed by parameter name
(``dict(model.named_parameters())``): the state is ``{"m": {name: f32},
"v": {name: f32}, "count": int32 scalar, "master": {name: f32}}``, on the
parameters' device.  The schedule, clipping, bias correction, weight decay
on the f32 master and the master copy are the reference's, and its scalars
(the clip scale, the bias corrections, the learning rate) are float32
tensors computed on the device: a step never waits on the host.

:func:`update` updates the state and the parameters in place with
PyTorch's multi-tensor ops (``torch._foreach_*``): a dozen calls whatever
the number of tensors, each a pass over the state.  Where the reference
rounds a product before a sum (``b1 m + (1 - b1) g``), the card may fuse
the two (one rounding fewer, a last-bit difference).  ``state_logical_axes``
gives the state's logical axes (ZeRO: the moments and the master copy are
sharded as their parameters); on DTensor parameters the state made by
:func:`init` has their placements and :func:`update` runs on DTensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # f32 master copy of bf16 params; off saves one f32 param-size buffer
    use_master: bool = True


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 on ``step``'s device."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                        - cfg.warmup_steps)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tensors, use_master: bool = True) -> Dict:
    """Zero moments (f32), ``count`` 0 and, with ``use_master``, an f32
    copy of every parameter; all on the parameters' device (the moments
    and the copy placed as their parameters when those are DTensors)."""
    zeros = lambda p: torch.zeros_like(                      # noqa: E731
        p, dtype=torch.float32, memory_format=torch.contiguous_format)
    with torch.no_grad():
        state = {
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device),
        }
        if use_master:
            state["master"] = {k: p.detach().float().clone()
                               for k, p in params.items()}
    return state


def state_logical_axes(param_axes, use_master: bool = True) -> Dict:
    """Optimizer-state logical axes mirror the parameters'."""
    axes = {"m": param_axes, "v": param_axes, "count": ()}
    if use_master:
        axes["master"] = param_axes
    return axes


def _local(tensors):
    """Each DTensor's shard on this rank (a plain tensor as it is)."""
    return [t.to_local() if hasattr(t, "to_local") else t for t in tensors]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32.  On a card
    it is the norm of the per-tensor norms (one multi-tensor call).  On the
    CPU those norms accumulate in one float32 running sum (3 % off over
    2e8 elements, stablelm-1.6b's embedding), so there each tensor's
    squares are summed by ``sum``, whose cascade keeps the error at the
    reference's level."""
    tensors = [t.float() for t in tensors]
    if tensors and tensors[0].device.type == "cpu":
        return torch.stack([torch.square(t).sum() for t in tensors]).sum(
        ).sqrt()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def update(grads: Tensors, state: Dict, params: Tensors, cfg: AdamWConfig
           ) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step; returns (params, state, metrics) as the reference
    does, with ``params`` and ``state`` updated in place (the same dicts and
    tensors) and metrics ``grad_norm`` (before clipping) and ``lr``, 0-dim
    float32 tensors on the device.  ``grads`` (any float dtype, keyed as
    ``params``) are left unchanged."""
    names = list(params)
    state["count"].add_(1)
    g = [grads[k].float() for k in names]
    g = [t.clone() if t is grads[k] else t for t, k in zip(g, names)]
    gnorm = global_norm(g)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    torch._foreach_mul_(g, scale)

    b1, b2 = cfg.b1, cfg.b2
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)              # b1 m + (1-b1) g
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)       # b2 v + (1-b2) g g
    del g
    c = state["count"].float()
    mhat_s = 1.0 / (1 - b1 ** c)
    vhat_s = 1.0 / (1 - b2 ** c)
    lr = schedule(cfg, state["count"])

    # upd = (m mhat_s) / (sqrt(v vhat_s) + eps); p32 -= lr (upd + wd p32)
    denom = torch._foreach_mul(v, vhat_s)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_mul(m, mhat_s)
    torch._foreach_div_(upd, denom)
    del denom
    if "master" in state:
        p32 = [state["master"][k] for k in names]
    else:
        p32 = [params[k].float() for k in names]
        p32 = [t.clone() if t is params[k] else t
               for t, k in zip(p32, names)]
    torch._foreach_add_(upd, p32, alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(p32, upd)
    del upd
    # DTensor has no rule for a multi-tensor copy; the master copy is
    # placed as its parameter, so the shards copy as they lie
    torch._foreach_copy_(_local([params[k] for k in names]), _local(p32))
    return params, state, {"grad_norm": gnorm, "lr": lr}
