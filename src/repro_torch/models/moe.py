"""Mixture-of-Experts layer: top-k routing, capacity-based grouped dispatch.

Port of ``src/repro/models/moe.py``.  Dispatch is the grouped, sort-based
scheme: tokens are split into groups, each group's assignments are sorted
by expert id (stable), each expert takes its first ``capacity`` assignments
and the rest go to an overflow sink row that is dropped, the experts run as
one batched einsum over (group, expert, slot), and the outputs are weighted
by the gates in the value dtype and summed.  Shared (always-on) experts
(DeepSeek-MoE) add a dense SwiGLU.  The reference maps its dispatch over
groups with ``vmap``; here every step is batched over the group axis.

``moe_axes`` and the hooks ``shard_ec``/``shard_rep`` are the reference's.
On DTensors (a sharded model) the dispatch and the combine, whose sorts and
scatters are group-local, run on each rank's groups (``local_map``, the
groups sharded as the batch is, replicated over the model axis: the
placement the reference's ``shard_rep`` pins); the expert einsums run on
DTensors, the experts sharded over the model axis.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.spmd import group_placements, is_dtensor


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


def moe_axes(n_shared: int = 0) -> Dict:
    a = {"router": ("embed", None), "w_gate": ("experts", "embed", None),
         "w_up": ("experts", "embed", None),
         "w_down": ("experts", None, "embed")}
    if n_shared:
        a["shared"] = L.mlp_axes(gated=True)
    return a


def _round_up(x: int, m: int) -> int:
    return int((x + m - 1) // m * m)


def capacity(tokens_per_group: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group: ``Tg * k / E * factor`` rounded up to a
    multiple of 16, and never more than the group's assignments."""
    c = _round_up(int(math.ceil(tokens_per_group * top_k / n_experts
                                * capacity_factor)), 16)
    return min(c, tokens_per_group * top_k)


def _dispatch(xf, eidx, E: int, C: int, top_k: int):
    """Each group's assignments sorted by expert (stable), each given its
    position within its expert, overflow to the sink row E * C.  Returns
    the (G, E, C, D) expert inputs and the bookkeeping (order, slot,
    valid), each (G, A)."""
    G, Tg, D = xf.shape
    A = Tg * top_k
    dev = xf.device
    fe = eidx.reshape(G, A)
    order = torch.argsort(fe, dim=-1, stable=True)
    fe_s = fe.gather(1, order)
    tok_s = order // top_k
    start = torch.searchsorted(
        fe_s, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos = torch.arange(A, device=dev) - start.gather(1, fe_s)
    valid = pos < C
    slot = torch.where(valid, fe_s * C + pos, E * C)      # (G, A)
    buf = torch.zeros((G, E * C + 1, D), dtype=xf.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(G, A, D),
                 xf.gather(1, tok_s[..., None].expand(G, A, D)))
    return buf[:, : E * C].reshape(G, E, C, D), order, slot, valid


def _combine(out, order, slot, valid, gates):
    """Each assignment's expert output (zero if dropped), back in (token,
    k) order, weighted by its gate in the value dtype and summed: (G, Tg,
    D)."""
    G, E, C, D = out.shape
    A = order.shape[1]
    flat = out.reshape(G, E * C, D)
    val_s = flat.gather(1, slot.clamp(max=E * C - 1)[..., None]
                        .expand(G, A, D))
    val_s = val_s * valid[..., None].to(val_s.dtype)
    val = torch.zeros_like(val_s).scatter_(
        1, order[..., None].expand(G, A, D), val_s)
    val = val.reshape(G, A // gates.shape[-1], gates.shape[-1], D)
    return (val * gates[..., None].to(val.dtype)).sum(2)


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, groups: Optional[int] = None,
              shard_ec=None, shard_rep=None,
              stats: Optional[dict] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    ``groups`` splits the B * S tokens into that many groups (default B),
    each dispatched on its own.  ``shard_ec`` and ``shard_rep`` constrain
    the (G, E, C, D) expert inputs and outputs (the reference's hooks).
    Given a dict, ``stats["kept"]`` receives a (G, Tg, top_k) bool tensor:
    whether each assignment (token, its j-th expert) got a slot; the others
    were dropped by the capacity.
    """
    B, S, D = x.shape
    E = p["router"].shape[1]
    G = groups or B
    T = B * S
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = capacity(Tg, top_k, E, capacity_factor)

    xf = x.reshape(G, Tg, D)
    logits = xf.float() @ p["router"]                     # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)        # (G, Tg, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    dispatch = lambda xf_, e_: _dispatch(xf_, e_, E, C, top_k)
    combine = _combine
    if is_dtensor(xf):
        from torch.distributed.tensor.experimental import local_map

        g = group_placements(xf.device_mesh, G)
        dispatch = local_map(dispatch, out_placements=(g, g, g, g),
                             in_placements=(g, g), redistribute_inputs=True)
        combine = local_map(_combine, out_placements=(g,),
                            in_placements=(g, g, g, g, g),
                            redistribute_inputs=True)
    ein, order, slot, valid = dispatch(xf, eidx)
    if shard_rep is not None:
        ein = shard_rep(ein)
    if shard_ec is not None:
        ein = shard_ec(ein)

    up = torch.einsum("gecd,edf->gecf", ein, p["w_up"])
    gate = torch.einsum("gecd,edf->gecf", ein, p["w_gate"])
    out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, p["w_down"])
    if shard_ec is not None:
        out = shard_ec(out)
    if shard_rep is not None:
        out = shard_rep(out)

    y = combine(out, order, slot, valid, gates)
    y = y.reshape(B, S, D).to(x.dtype)
    if stats is not None:
        kept = torch.zeros_like(valid).scatter_(1, order, valid)
        stats["kept"] = kept.reshape(G, Tg, top_k)

    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x, gated=True)
    return y
