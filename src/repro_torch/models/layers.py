"""Shared neural-net layers of the model zoo.

Port of ``src/repro/models/layers.py``.  Parameters are dicts of tensors
(``nn.ParameterDict`` inside the model) in the reference's ``(in, out)``
layout, applied as ``x @ W``; initializers draw from an explicit
``torch.Generator`` on the device the weights live on.

Training/prefill attention is blocked over queries: each q block scores the
whole sequence at once, so the peak intermediate is (B, H, block_q, S), never
S x S.  One-token decode attention (:func:`attention_decode_apply`) runs
kernel 2, ``kernels.ops.flash_decode_attention``: on a CUDA tensor it
launches the hand-written kernel (or raises), on a CPU tensor it runs the
kernel's plain version.  :func:`decode_attention` is the plain mirror of the
reference's decode attention; the tests and ``chip_smoke.py`` compare
kernel 2 with it, and no model path calls it.

``attention_axes`` and ``mlp_axes`` are the reference's logical sharding
axes.  On DTensors (a sharded model, ``models.base``) the blocked
attention, the decode step's cache writes and kernel 2 run on each rank's
own batch rows and heads (``local_map``; :func:`local_decode`): rows and
heads are independent, so they need no communication.  A cache sharded
along its sequence (the rules give the model axis to ``cache_seq`` where
the KV heads do not divide it) is decoded sequence-parallel, as the
reference's GSPMD partitions it: each rank writes the new token only if
its position falls in the rank's slice, runs kernel 2's partial pass over
its slice, and the ranks' ``(m, l, acc)`` partials, gathered over the
axis, are folded by kernel 2's combine pass (the fold of
``hybrid.executor.merge_attention_partials``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.spmd import (head_placements, is_dtensor, on_shards,
                                     split_heads)

Params = Mapping[str, torch.Tensor]

# the standard normal's CDF at -2 and 2: the truncation points of dense_init
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, scale_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1 / fan_in) cut at two standard
    deviations, drawn in float32 on ``generator``'s device by inverse-CDF
    sampling (as ``torch.nn.init.trunc_normal_``), then cast to ``dtype``."""
    std = 1.0 / math.sqrt(shape[scale_axis])
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t.uniform_(2.0 * _PHI_LO - 1.0, 2.0 * _PHI_HI - 1.0, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    return t.to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        # a row-parallel product's partial sums (the residual stream) are
        # reduced here, as Megatron and GSPMD do: left to DTensor, the norm
        # scatters them over the sequence, and the next product's flattened
        # (B * S, D) operand then takes a strided sharding that DTensor
        # cannot place on fake tensors
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, d); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (d/2,)
    angles = positions[..., None].float() * freqs              # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention — blocked causal (training / prefill)
# --------------------------------------------------------------------------
def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, block_q: int = 512,
                               causal: bool = True) -> torch.Tensor:
    """GQA attention without an S x S intermediate.

    q: (B, S, H, d); k, v: (B, S, Hkv, d).  Each block of ``block_q``
    queries scores the full K in float32 (masked causally) and is
    normalised on its own; the peak intermediate is (B, H, block_q, S).
    A sequence that ``block_q`` does not divide is one block, as in the
    reference.
    """
    B, S, H, d = q.shape
    group = H // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    if S % block_q:
        block_q = S
    kg = k.float().repeat_interleave(group, dim=2) if group > 1 \
        else k.float()                                          # (B, S, H, d)
    vg = v.float().repeat_interleave(group, dim=2) if group > 1 \
        else v.float()
    kv_pos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, S, block_q):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + block_q].float(),
                         kg) * scale
        if causal:
            q_pos = q0 + torch.arange(block_q, device=q.device)
            s = torch.where(kv_pos[None, :] <= q_pos[:, None], s, -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p, vg)
        o = o / p.sum(-1).transpose(1, 2)[..., None]
        out[:, q0:q0 + block_q] = o.to(q.dtype)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention against a cache: the plain mirror of the
    reference's ``decode_attention``, rounding as it does.

    q: (B, H, d); caches: (B, Smax, Hkv, d); length: (B,).  ``q * scale``
    and the probabilities are rounded to the cache dtype before their
    products, which are summed in float32.  Kernel 2 (the model's path)
    keeps both in float32 instead, so in 16 bits the two differ by that
    rounding.
    """
    B, H, d = q.shape
    hkv = k_cache.shape[2]
    group = H // hkv
    scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).to(k_cache.dtype).reshape(B, hkv, group, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(pos[None, None, None, :]
                    < length.reshape(B, 1, 1, 1), s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o / denom[..., None]
    return o.reshape(B, H, d).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention block (params + apply)
# --------------------------------------------------------------------------
def attention_init(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qkv_bias: bool,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    p = {
        "wq": dense_init(generator, (d_model, n_heads * head_dim), 0, dtype),
        "wk": dense_init(generator, (d_model, n_kv * head_dim), 0, dtype),
        "wv": dense_init(generator, (d_model, n_kv * head_dim), 0, dtype),
        "wo": dense_init(generator, (n_heads * head_dim, d_model), 0, dtype),
    }
    if qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
    return p


def attention_axes(qkv_bias: bool) -> Dict[str, tuple]:
    a = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if qkv_bias:
        a.update({"bq": ("heads",), "bk": ("kv_heads",),
                  "bv": ("kv_heads",)})
    return a


def _project(p: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    y = x @ p["w" + name]
    return y + p["b" + name] if ("b" + name) in p else y


def attention_apply(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, positions: torch.Tensor,
                    rope_theta: float, causal: bool = True,
                    block_q: int = 512):
    """Full-sequence attention (training / prefill).  Returns (out, (k, v))."""
    B, S, _ = x.shape
    q = split_heads(_project(p, x, "q"), n_heads, head_dim)
    k = split_heads(_project(p, x, "k"), n_kv, head_dim)
    v = split_heads(_project(p, x, "v"), n_kv, head_dim)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    attn = lambda q_, k_, v_: blockwise_causal_attention(   # noqa: E731
        q_, k_, v_, block_q=block_q, causal=causal)
    if is_dtensor(q):
        # each rank attends with its own batch rows and heads
        pl = head_placements(q.device_mesh, B, (n_heads, n_kv), 2)
        attn = on_shards(attn, (pl, pl, pl), (pl,))
    o = attn(q, k, v)
    return o.reshape(B, S, n_heads * head_dim) @ p["wo"], (k, v)


def attention_decode_apply(p: Params, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: torch.Tensor, *, n_heads: int, n_kv: int,
                           head_dim: int, rope_theta: float) -> torch.Tensor:
    """One-token attention: project, write k/v into the caches at position
    ``length`` (in place), attend over ``length + 1`` positions (the new
    token sees itself) with kernel 2.  x: (B, D); caches (B, Smax, Hkv, d);
    length (B,) int32 on the caches' device.  Returns the (B, D) output."""
    B, _ = x.shape
    q = split_heads(_project(p, x, "q"), n_heads, head_dim)
    k = split_heads(_project(p, x, "k"), n_kv, head_dim)
    v = split_heads(_project(p, x, "v"), n_kv, head_dim)
    if rope_theta:
        pos = length.float()[:, None]                        # (B, 1)
        q = apply_rope(q[:, None], pos, rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos, rope_theta)[:, 0]
    o = local_decode(q, k, v, k_cache, v_cache, length)
    return o.reshape(B, n_heads * head_dim) @ p["wo"]


# the launch-count path of kernel 2 on a sequence-sharded cache
SEQ_DECODE_PATH = "seq_decode"


def _decode_core(q, k, v, k_cache, v_cache, length):
    cache_update(k_cache, k.to(k_cache.dtype), length)
    cache_update(v_cache, v.to(v_cache.dtype), length)
    return kops.flash_decode_attention(q, k_cache, v_cache, length + 1)


def _seq_gather(parts, mesh, dims):
    """Each rank's (m, l, acc) partials (B, H, n) / (B, H, n, d), gathered
    over the mesh dims ``dims`` (outer first) in one collective, in the
    order of the sequence slices: (B, H, W n) / (B, H, W n, d)."""
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    m, l, acc = parts
    B, H, n, d = acc.shape
    flat = torch.cat([m.reshape(-1), l.reshape(-1), acc.reshape(-1)])[None]
    for dim in reversed(dims):          # innermost first: outer-major order
        flat = gather(flat, 0, (mesh, dim))
    W, k = flat.shape[0], B * H * n
    m, l, acc = flat[:, :k], flat[:, k:2 * k], flat[:, 2 * k:]
    return (m.reshape(W, B, H, n).permute(1, 2, 0, 3).reshape(B, H, W * n)
            .contiguous(),
            l.reshape(W, B, H, n).permute(1, 2, 0, 3).reshape(B, H, W * n)
            .contiguous(),
            acc.reshape(W, B, H, n, d).permute(1, 2, 0, 3, 4)
            .reshape(B, H, W * n, d).contiguous())


def seq_slice_partials(q, k, v, k_cache, v_cache, length, index: int):
    """One rank's part of a sequence-parallel decode: its caches (B,
    S_local, Hkv, d) hold positions ``index * S_local`` on.  The new
    token's k, v are written row by row where ``length`` falls in the
    slice, and kernel 2's partial pass runs over the slice's
    ``clamp(length + 1 - offset, 0, S_local)`` valid positions (an empty
    slice gives exactly ``(NEG_INF, 0, 0)``, which folds to zero).
    Returns the slice's ``(m, l, acc)``, counted under
    :data:`SEQ_DECODE_PATH`."""
    from repro_torch.kernels import flash_attention as kfa

    S_local = k_cache.shape[1]
    offset = index * S_local
    cache_update(k_cache, k.to(k_cache.dtype), length, offset)
    cache_update(v_cache, v.to(v_cache.dtype), length, offset)
    lens = (length + 1 - offset).clamp(0, S_local)
    return kfa.flash_partial(q, k_cache, v_cache, lens,
                             path=SEQ_DECODE_PATH)


def seq_combine(parts, dtype: torch.dtype) -> torch.Tensor:
    """Every slice's partials, in slice order along the split axis (m, l
    (B, H, W n), acc (B, H, W n, d)), folded by kernel 2's combine pass
    into the (B, H, d) output in ``dtype``, counted under
    :data:`SEQ_DECODE_PATH`."""
    from repro_torch.kernels import flash_attention as kfa
    return kfa.flash_combine(parts, normalise=True, out_dtype=dtype,
                             path=SEQ_DECODE_PATH)


def _seq_decode_core(mesh, dims, q, k, v, k_cache, v_cache, length):
    index = 0
    for dim in dims:
        index = index * mesh.size(dim) + mesh.get_local_rank(dim)
    parts = seq_slice_partials(q, k, v, k_cache, v_cache, length, index)
    return seq_combine(_seq_gather(parts, mesh, dims), q.dtype)


def local_decode(q, k, v, k_cache, v_cache, length):
    """Writes the new token's k, v (B, Hkv, d) into the caches (B, Smax,
    Hkv, d) at ``length`` and runs kernel 2 for q (B, H, d).  On DTensor
    caches both run on each rank's shard of the caches as they are placed:
    batch rows and KV heads sharded or replicated, each rank on its own;
    the sequence sharded, sequence-parallel (:func:`seq_slice_partials`
    on each rank's slice, the partials gathered over the mesh dims that
    shard it, :func:`seq_combine`).  q, k, v and
    ``length`` are redistributed to match."""
    if not is_dtensor(k_cache):
        return _decode_core(q, k, v, k_cache, v_cache, length)
    import functools

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    cp = tuple(k_cache.placements)
    if tuple(v_cache.placements) != cp or any(
            not isinstance(pl, (Shard, Replicate))
            or isinstance(pl, Shard) and pl.dim not in (0, 1, 2)
            for pl in cp):
        raise NotImplementedError(
            f"decode on caches placed {cp}: only batch rows, the sequence "
            "and KV heads may be sharded")
    shard = lambda pl, dim: isinstance(pl, Shard) and pl.dim == dim  # noqa
    head = tuple(Shard(1) if shard(pl, 2) else
                 pl if shard(pl, 0) else Replicate()
                 for pl in cp)                       # (B, H, d) placements
    rows = tuple(pl if shard(pl, 0) else Replicate()
                 for pl in cp)                       # (B,) placements
    seq = tuple(i for i, pl in enumerate(cp) if shard(pl, 1))
    core = functools.partial(_seq_decode_core, k_cache.device_mesh, seq) \
        if seq else _decode_core
    return local_map(core, out_placements=(head,),
                     in_placements=(head, head, head, cp, cp, rows),
                     redistribute_inputs=True)(q, k, v, k_cache, v_cache,
                                               length)


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------
def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    p = {
        "w_up": dense_init(generator, (d_model, d_ff), 0, dtype),
        "w_down": dense_init(generator, (d_ff, d_model), 0, dtype),
    }
    if gated:
        p["w_gate"] = dense_init(generator, (d_model, d_ff), 0, dtype)
    return p


def mlp_axes(gated: bool = True) -> Dict[str, tuple]:
    a = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    if gated:
        a["w_gate"] = ("embed", "ffn")
    return a


def mlp_apply(p: Params, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    up = x @ p["w_up"]
    if gated:
        up = F.silu(x @ p["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return up @ p["w_down"]


# --------------------------------------------------------------------------
# embedding / cache
# --------------------------------------------------------------------------
def embedding_init(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32) -> torch.Tensor:
    return dense_init(generator, (vocab, d_model), 1, dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 length: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Write ``new`` (B, Hkv, d) into ``cache`` (B, Smax, Hkv, d) at per-row
    position ``length`` (B,), in place; returns ``cache``.  With
    ``offset``, ``cache`` holds positions ``offset`` to ``offset + Smax -
    1`` (one slice of a sequence-sharded cache) and a row is written at
    ``length - offset``.

    The reference's one-hot select gives the same values for a finite
    cache, and writes nothing to a row whose position lies outside the
    cache: here such a row gets an entry of its own back, so no index
    leaves the cache and ``length`` never leaves the device.
    """
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    if offset == 0:         # the plain decode step's: three ops, not six
        at = length.long().clamp(max=S - 1)
        keep = (length < S).reshape(B, 1, 1)
    else:
        at = length.long() - offset
        keep = ((at >= 0) & (at < S)).reshape(B, 1, 1)
        at = at.clamp(0, S - 1)
    cache[rows, at] = torch.where(keep, new.to(cache.dtype), cache[rows, at])
    return cache
