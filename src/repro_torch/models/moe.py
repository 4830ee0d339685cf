"""Mixture-of-Experts layer: top-k routing, capacity-based grouped dispatch.

Port of ``src/repro/models/moe.py``.  Dispatch is the grouped, sort-based
scheme: tokens are split into groups, each group's assignments are sorted
by expert id (stable), each expert takes its first ``capacity`` assignments
and the rest go to an overflow sink row that is dropped, the experts run as
one batched einsum over (group, expert, slot), and the outputs are weighted
by the gates in the value dtype and summed.  Shared (always-on) experts
(DeepSeek-MoE) add a dense SwiGLU.  The reference maps its dispatch over
groups with ``vmap``; here every step is batched over the group axis.

The reference's sharding hooks (``shard_ec``/``shard_rep``) and
``moe_axes`` wait for ROADMAP module item 13.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, n_shared: int = 0,
             dtype=torch.float32) -> Dict:
    p = {
        "router": L.dense_init(generator, (d_model, n_experts), 0,
                               torch.float32),
        "w_gate": L.dense_init(generator, (n_experts, d_model, d_ff), 1,
                               dtype),
        "w_up": L.dense_init(generator, (n_experts, d_model, d_ff), 1, dtype),
        "w_down": L.dense_init(generator, (n_experts, d_ff, d_model), 1,
                               dtype),
    }
    if n_shared:
        p["shared"] = L.mlp_init(generator, d_model, n_shared * d_ff,
                                 gated=True, dtype=dtype)
    return p


def _round_up(x: int, m: int) -> int:
    return int((x + m - 1) // m * m)


def capacity(tokens_per_group: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group: ``Tg * k / E * factor`` rounded up to a
    multiple of 16, and never more than the group's assignments."""
    c = _round_up(int(math.ceil(tokens_per_group * top_k / n_experts
                                * capacity_factor)), 16)
    return min(c, tokens_per_group * top_k)


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, groups: Optional[int] = None,
              stats: Optional[dict] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    ``groups`` splits the B * S tokens into that many groups (default B),
    each dispatched on its own.  Given a dict, ``stats["kept"]`` receives a
    (G, Tg, top_k) bool tensor: whether each assignment (token, its j-th
    expert) got a slot; the others were dropped by the capacity.
    """
    B, S, D = x.shape
    E = p["router"].shape[1]
    G = groups or B
    T = B * S
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    A = Tg * top_k                                        # assignments
    C = capacity(Tg, top_k, E, capacity_factor)
    dev = x.device

    xf = x.reshape(G, Tg, D)
    logits = xf.float() @ p["router"]                     # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)        # (G, Tg, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    # dispatch: sort each group's assignments by expert (stable), give each
    # its position within its expert, overflow to the sink row E * C
    fe = eidx.reshape(G, A)
    order = torch.argsort(fe, dim=-1, stable=True)
    fe_s = fe.gather(1, order)
    tok_s = order // top_k
    start = torch.searchsorted(
        fe_s, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos = torch.arange(A, device=dev) - start.gather(1, fe_s)
    valid = pos < C
    slot = torch.where(valid, fe_s * C + pos, E * C)      # (G, A)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(G, A, D),
                 xf.gather(1, tok_s[..., None].expand(G, A, D)))
    ein = buf[:, : E * C].reshape(G, E, C, D)

    up = torch.einsum("gecd,edf->gecf", ein, p["w_up"])
    gate = torch.einsum("gecd,edf->gecf", ein, p["w_gate"])
    out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, p["w_down"])

    # combine: each assignment's expert output (zero if dropped), back in
    # (token, k) order, weighted by its gate in the value dtype
    flat = out.reshape(G, E * C, D)
    val_s = flat.gather(1, slot.clamp(max=E * C - 1)[..., None]
                        .expand(G, A, D))
    val_s = val_s * valid[..., None].to(val_s.dtype)
    val = torch.zeros_like(val_s).scatter_(
        1, order[..., None].expand(G, A, D), val_s)
    val = val.reshape(G, Tg, top_k, D)
    y = (val * gates[..., None].to(val.dtype)).sum(2)
    y = y.reshape(B, S, D).to(x.dtype)
    if stats is not None:
        kept = torch.zeros_like(valid).scatter_(1, order, valid)
        stats["kept"] = kept.reshape(G, Tg, top_k)

    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x, gated=True)
    return y
