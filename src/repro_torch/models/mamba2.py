"""Mamba2 (SSD) blocks — the state-space family (zamba2's backbone, and
standalone as ``Mamba2Model``).

Port of ``src/repro/models/mamba2.py``.  The SSD computation streams the
sequence in chunks: dense intra-chunk work in the matrix form, and a small
recurrent state (B, H, P, N) carried between chunks.  The per-step scan
(``ssd_scan_ref``) is the test oracle.  Both run as PyTorch ops on the
model's device: the reference writes them in plain ``jnp`` and no Pallas
kernel is on this path.

The reference's ``unroll`` flag chooses between ``lax.scan`` and a Python
loop over the chunks; eager PyTorch has only the loop, which is what
:func:`ssd_chunked` runs.  The flag's other effect is kept: with
``cfg.scan_layers`` off (the reference's cost mode) :func:`mamba_apply`
bounds the chunk count, as the reference does.

Decode carries (state h, conv tail) in O(1) memory.  :func:`mamba_decode`
updates both in place, so a model's cache tensors (or views of them) are
advanced without copies.  ``mamba_axes`` are the reference's logical
sharding axes; the models take the reference's ``weight_gather`` hook.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.base import ZooModel, remat
from repro_torch.models.spmd import (batch_local, grad_placed_as_value,
                                     is_dtensor, keep_shards, on_shards,
                                     split_heads, write_)

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
def ssd_scan_ref(x, dt, a, B_, C_):
    """Naive per-step recurrence (oracle).

    x: (B, S, H, P); dt, a: (B, S, H); B_, C_: (B, S, N).
    h_t = a_t * h_{t-1} + dt_t * x_t ⊗ B_t ;  y_t = C_t · h_t.
    Returns y: (B, S, H, P) float32, h_final: (B, H, P, N) float32.
    """
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf, af, Bf, Cf = (t.float() for t in (x, dt, a, B_, C_))
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = af[:, t, :, None, None] * h + (
            (dtf[:, t, :, None] * xf[:, t])[..., None]
            * Bf[:, t, None, None, :])
        ys.append((h @ Cf[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, a, B_, C_, chunk: int = 256,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD (Mamba2 algorithm; matrix form inside a chunk, the state
    carried between chunks).  Same contract as :func:`ssd_scan_ref`, with y
    in x's dtype.  All decays are at most 1 by construction, so the matrix
    form is numerically safe (log a <= 0)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if S % chunk:
        # the reference's rule: a length the chunk does not divide is one
        # chunk of S.  Its decay tensor is then (B, S, S, H) float32,
        # 4·B·S²·H bytes: 1 GB at B 4, S 1000, H 64.
        chunk = S
    h = h0 if h0 is not None else torch.zeros(
        (Bb, H, P, N), dtype=torch.float32, device=x.device)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, ac = x[:, sl], dt[:, sl], a[:, sl]
        bc, cc = B_[:, sl].float(), C_[:, sl].float()
        la = torch.log(torch.clamp(ac.float(), min=1e-20))
        ca = torch.cumsum(la, dim=1)                           # (B, Lc, H)
        # intra-chunk: scores[t,s] = (C_t·B_s) exp(ca[t]-ca[s]) dt_s, s<=t
        cb = torch.einsum("bln,bmn->blm", cc, bc)              # (B, Lc, Lc)
        # masked before the exp, not after as in the reference: above the
        # diagonal ca[t] - ca[s] > 0 can overflow (past 88 in a long chunk),
        # and the reference's where(mask, exp(.), 0) then has a 0 * inf =
        # NaN gradient; the forward values are the same
        decay = torch.exp(torch.where(
            mask, ca[:, :, None, :] - ca[:, None, :, :], -torch.inf))
        scores = cb[..., None] * decay                         # (B,t,s,H)
        xdt = xc.float() * dtc[..., None]                      # (B,Lc,H,P)
        y = torch.einsum("blsh,bshp->blhp", scores, xdt)
        # inter-chunk: y += exp(ca[t]) * C_t · h
        y = y + torch.exp(ca)[..., None] * torch.einsum(
            "bln,bhpn->blhp", cc, h)
        # state: h' = exp(ca[-1]) h + sum_s exp(ca[-1]-ca[s]) dt_s x_s⊗B_s
        tail = torch.exp(ca[:, -1:, :] - ca)                   # (B, Lc, H)
        hc = torch.einsum("blhp,bln->bhpn", xdt * tail[..., None], bc)
        h = torch.exp(ca[:, -1])[..., None, None] * h + hc
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


# --------------------------------------------------------------------------
# causal depthwise conv (width W) over (B, S, C)
# --------------------------------------------------------------------------
def causal_conv(x, w, tail: Optional[torch.Tensor] = None):
    """x: (B, S, C); w: (W, C); tail: (B, W-1, C) state for decode/prefill
    continuity.  Returns (y (B, S, C), new_tail (B, W-1, C), a view of a
    new tensor)."""
    W, S = w.shape[0], x.shape[1]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)                            # (B, S+W-1, C)
    y = xp[:, :S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, -(W - 1):]


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------
def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def mamba_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """The reference's initializers; ``A_log``, ``D_skip`` and ``dt_bias``
    are float32 constants whatever the model's dtype."""
    d, (di, H, P, N) = cfg.d_model, mamba_dims(cfg)
    conv_dim = di + 2 * N
    dt, dev = cfg.pdtype, generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": L.dense_init(generator, (d, 2 * di + 2 * N + H), 0, dt),
        "conv_w": L.dense_init(generator, (cfg.conv_width, conv_dim), 0, dt),
        "A_log": torch.zeros((H,), **f32),
        "D_skip": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "gate_norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": L.dense_init(generator, (di, d), 0, dt),
    }


def mamba_axes(cfg: ArchConfig) -> Dict[str, tuple]:
    return {"in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
            "A_log": (None,), "D_skip": (None,), "dt_bias": (None,),
            "gate_norm": ("inner",), "out_proj": ("inner", "embed")}


def _mamba_project(p: Params, x, cfg: ArchConfig):
    di, H, P, N = mamba_dims(cfg)
    z, xbc, dt = torch.split(grad_placed_as_value(x @ p["in_proj"]),
                             [di, di + 2 * N, H], dim=-1)
    return z, xbc, dt


def mamba_apply(p: Params, x, cfg: ArchConfig, chunk: int = 256):
    """Full-sequence Mamba2 block.  x: (B, S, D) -> (y, h_final, conv_tail)."""
    Bb, S, D = x.shape
    di, H, P, N = mamba_dims(cfg)
    z, xbc, dt = _mamba_project(p, x, cfg)
    xbc, tail = causal_conv(xbc, p["conv_w"])
    xbc = F.silu(xbc)
    xs, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)
    xs = split_heads(xs, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, S, H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                 # (B, S, H)
    if not cfg.scan_layers:  # cost mode: bound the unrolled chunk count
        chunk = max(chunk, S // 8 if S >= 8 else S)
    ssd = lambda *t: ssd_chunked(*t, chunk=chunk)              # noqa: E731
    if is_dtensor(xs):
        ssd = batch_local(ssd, 2)
    y, h = ssd(xs, dt, a, B_, C_)
    y = y + p["D_skip"][None, None, :, None] * xs.float()
    y = y.reshape(Bb, S, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], h, tail


def _ssm_step(h, a, dtx, B_, C_):
    """h <- a h + dtx ⊗ B in place; returns C · h.  h: (B, H, P, N);
    a: (B, H); dtx: (B, H, P); B_, C_: (B, N), all float32."""
    h.mul_(a[..., None, None]).add_(dtx[..., None] * B_[:, None, None, :])
    return (h @ C_[:, None, :, None])[..., 0]                  # (B, H, P)


def mamba_decode(p: Params, x, h, conv_tail, cfg: ArchConfig):
    """One-token step.  x: (B, D); h: (B, H, P, N) float32; conv_tail:
    (B, W-1, conv).  ``h`` and ``conv_tail`` are advanced in place (they may
    be views of a cache) and returned: (y, h, conv_tail)."""
    Bb, D = x.shape
    di, H, P, N = mamba_dims(cfg)
    z, xbc, dt = _mamba_project(p, x[:, None], cfg)
    xbc, tail = causal_conv(xbc, p["conv_w"], conv_tail)
    write_(conv_tail, tail)
    xbc = F.silu(xbc[:, 0])                                    # (B, conv)
    z = z[:, 0]
    xs, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)
    xs = split_heads(xs, H, P).float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                 # (B, H)
    step = _ssm_step
    if is_dtensor(h):
        # in place on each rank's rows and heads of the cache's state
        heads, rows = keep_shards(h.placements, (0, 1)), \
            keep_shards(h.placements, (0,))
        step = on_shards(_ssm_step, (h.placements, heads, heads, rows,
                                     rows), (heads,))
    y = step(h, a, dt[..., None] * xs, B_.float(), C_.float())
    y = y + p["D_skip"][None, :, None] * xs
    y = y.reshape(Bb, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], h, conv_tail


# a residual Mamba2 layer, the unit of Mamba2Model's and Zamba2Model's stacks
def mamba_layer_init(generator: torch.Generator, cfg: ArchConfig) -> Dict:
    return {"norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                               device=generator.device),
            "mamba": mamba_init(generator, cfg)}


def mamba_layer_apply(lp, x, cfg: ArchConfig):
    """(x + the block on the normed x, h_final, conv_tail)."""
    y, h, tail = mamba_apply(lp["mamba"], L.rms_norm(x, lp["norm"],
                                                     cfg.norm_eps), cfg)
    return x + y, h, tail


def mamba_layer_out(lp, x, cfg: ArchConfig):
    """The layer's output alone (the unit a recorded forward remats)."""
    return mamba_layer_apply(lp, x, cfg)[0]


def mamba_layer_decode(lp, x, h, conv_tail, cfg: ArchConfig):
    """One token through the layer; ``h`` and ``conv_tail`` in place."""
    return x + mamba_decode(lp["mamba"], L.rms_norm(x, lp["norm"],
                                                    cfg.norm_eps),
                            h, conv_tail, cfg)[0]


def mamba_cache(cfg: ArchConfig, batch: int, device) -> Cache:
    """Zeroed per-layer decode state: h (L, B, H, P, N) float32, the conv
    tails (L, B, W-1, conv) in the activation dtype, ``len`` (B,)."""
    di, H, P, N = mamba_dims(cfg)
    Lr = cfg.num_layers
    return {
        "h": torch.zeros((Lr, batch, H, P, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((Lr, batch, cfg.conv_width - 1, di + 2 * N),
                            dtype=cfg.adtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


class Mamba2Model(ZooModel):
    """Pure-SSM decoder (the family ``ssm`` with ``ssm_state > 0``), the
    same API as ``TransformerModel``:

      Mamba2Model(cfg, device=None)  CUDA unless ``device`` names another
      init(generator) -> self
      forward(inputs) -> logits (B, S, V)
      init_cache(batch, max_len) -> {"h", "conv", "len"} (max_len unused)
      prefill(inputs, max_len) -> (last-token logits, cache)
      decode(cache, inputs) -> (logits, cache)  h and conv in place
    """

    def init(self, generator: torch.Generator) -> "Mamba2Model":
        """Random weights (the reference's initializers) drawn from
        ``generator``, which must live on the model's device."""
        self._check_generator(generator)
        with torch.device(self.device):
            layers = [mamba_layer_init(generator, self.cfg)
                      for _ in range(self.cfg.num_layers)]
            top = self._top_init(generator)
        return self.set_params(layers, top)

    def layer_axes(self) -> Dict:
        return {"norm": ("embed",), "mamba": mamba_axes(self.cfg)}

    def cache_logical_axes(self) -> Dict:
        return {"h": ("layer", "batch", "inner_heads", None, None),
                "conv": ("layer", "batch", None, "inner"),
                "len": ("batch",)}

    def _layer_out(self, lp, x):
        return mamba_layer_out(self._gather(lp, self.layer_axes()), x,
                               self.cfg)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            for lp in self.layers:
                x = remat(self.cfg.remat, self._layer_out, lp, x)
            return self._head(top, x)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return mamba_cache(self.cfg, batch, self.device)

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process a full prompt; return (last-token logits, the state
        after it).  The state does not grow with length: ``max_len`` is
        accepted and unused, as in the reference."""
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            B, S = x.shape[:2]
            cache = self._prefill_cache(B, S)
            for i, lp in enumerate(self.layers):
                x, h, conv = mamba_layer_apply(
                    self._gather(lp, self.layer_axes()), x, self.cfg)
                write_(cache["h"][i], h)
                write_(cache["conv"][i], conv)
            cache["len"].fill_(S)
            return self._head(top, x[:, -1]), cache

    @torch.no_grad()
    def decode(self, cache: Cache, inputs: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  inputs: (B,) token ids.  The cache's h and conv
        are advanced in place; the returned cache has ``len`` + 1."""
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            for i, lp in enumerate(self.layers):
                x = mamba_layer_decode(self._gather(lp, self.layer_axes()),
                                       x, cache["h"][i], cache["conv"][i],
                                       self.cfg)
            return self._head(top, x), dict(cache, len=cache["len"] + 1)
