"""RWKV-6 "Finch": attention-free time-mix with data-dependent decay.

Port of ``src/repro/models/rwkv6.py``.  The state per layer is a
(B, H, P, P) matrix, O(1) in sequence length.  Three forms of the WKV
recurrence, all PyTorch ops on the model's device (the reference writes
them in plain ``jnp``; no Pallas kernel is on this path):

- :func:`wkv_scan_ref`, the per-step recurrence (the oracle, and decode);
- :func:`wkv_chunked`, an outer loop over chunks carrying M with the
  per-step recurrence inside each; with ``remat`` (``cfg.remat``) each
  chunk is rematerialised in the backward, as in the reference, so a
  recorded forward keeps only the chunk-boundary states;
- :func:`wkv_associative`, the parallel form: log2(S) combine steps over
  tensors (torch has no ``associative_scan``), materialising (B, S, H, P, P).

``timemix_apply`` takes the associative form when ``unroll`` (a model sets
it to ``not cfg.scan_layers``, as the reference does) and the chunked form
otherwise.  The chunked form runs S steps of a few small ops per layer, so
a long prompt's prefill is bound by the host's op issue.

Faithful simplifications (the reference's DESIGN.md §5): static token-shift
mix coefficients, one w projection for the decay.  Head layout: H heads of
size P, D = H*P.  ``timemix_axes`` and ``chanmix_axes`` are the
reference's logical sharding axes; the model takes the reference's
``weight_gather`` hook.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.base import ZooModel, remat as remat_call
from repro_torch.models.spmd import (batch_local, batch_sharded, is_dtensor,
                                     keep_shards, on_shards, split_heads,
                                     write_)

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# wkv recurrence
# --------------------------------------------------------------------------
def _wkv_step(M, r, uk, k, v, w):
    """One step on (B, H, P) float32 rows, ``uk`` = u * k:
    y = r · (M + uk ⊗ v), then M <- w ⊙ M + k ⊗ v in place.  Returns y."""
    cur = uk[..., None] * v[..., None, :]                      # (B,H,P,P)
    y = (r[..., None, :] @ (M + cur))[..., 0, :]
    M.mul_(w[..., None]).add_(k[..., None] * v[..., None, :])
    return y


def wkv_scan_ref(r, k, v, w, u, m0=None):
    """Oracle: per-step.  r, k, v, w: (B, S, H, P); u: (H, P).

    y_t = r_t · (M_{t-1} + diag(u) k_t ⊗ v_t);  M_t = diag(w_t) M_{t-1} + k_t ⊗ v_t
    Returns y (B, S, H, P) and M_final (B, H, P, P), float32; ``m0`` is
    not modified.
    """
    B, S, H, P = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    M = m0.float().clone() if m0 is not None else torch.zeros(
        (B, H, P, P), dtype=torch.float32, device=r.device)
    uk = u * kf
    ys = [_wkv_step(M, rf[:, t], uk[:, t], kf[:, t], vf[:, t], wf[:, t])
          for t in range(S)]
    return torch.stack(ys, dim=1), M


def wkv_associative(r, k, v, w, u, m0: Optional[torch.Tensor] = None):
    """Parallel WKV: the recurrence M_t = w_t ⊙ M_{t-1} + k_t ⊗ v_t is a
    linear scan with the associative composition (w2*w1, w2*a1 + a2),
    here as log2(S) Hillis-Steele steps.  Materialises (B, S, H, P, P)
    states; equal to :func:`wkv_scan_ref` within rounding."""
    B, S, H, P = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    A = kf[..., None] * vf[..., None, :]                       # (B,S,H,P,P)
    W = wf[..., None]                                          # (B,S,H,P,1)
    d = 1
    while d < S:            # element t absorbs the prefix ending at t - d
        A = torch.cat([A[:, :d], W[:, d:] * A[:, :-d] + A[:, d:]], dim=1)
        W = torch.cat([W[:, :d], W[:, d:] * W[:, :-d]], dim=1)
        d *= 2
    M = A + W * m0[:, None] if m0 is not None else A           # M_t
    m_init = m0 if m0 is not None else torch.zeros(
        (B, H, P, P), dtype=torch.float32, device=r.device)
    M_prev = torch.cat([m_init[:, None], M[:, :-1]], dim=1)
    cur = (u * kf)[..., None] * vf[..., None, :]
    y = torch.einsum("bshp,bshpq->bshq", rf, M_prev + cur)
    return y, M[:, -1]


def wkv_chunked(r, k, v, w, u, chunk: int = 64,
                m0: Optional[torch.Tensor] = None, remat: bool = False):
    """Outer loop over chunks carrying M, the per-step recurrence inside
    each; with ``remat`` and autograd recording, each chunk's steps are
    recomputed in the backward.  A length the chunk does not divide is one
    chunk, as in the reference."""
    S = r.shape[1]
    if S % chunk:
        chunk = S
    M, ys = m0, []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y, M = remat_call(remat, wkv_scan_ref, r[:, sl], k[:, sl], v[:, sl],
                          w[:, sl], u, M)
        ys.append(y)
    return torch.cat(ys, dim=1), M


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _shift(x, last):
    """Token shift: x_{t-1} with ``last`` filling t=0.  x: (B, S, D)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def timemix_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """The reference's initializers; ``u`` is a float32 constant whatever
    the model's dtype."""
    D = cfg.d_model
    P = cfg.ssm_head_dim
    H = D // P
    dt, dev = cfg.pdtype, generator.device
    p = {"mu": torch.full((5, D), 0.5, dtype=dt, device=dev)}  # r,k,v,g,w
    for name in ("w_r", "w_k", "w_v", "w_g", "w_w", "w_o"):
        p[name] = L.dense_init(generator, (D, D), 0, dt)
    p["u"] = torch.zeros((H, P), dtype=torch.float32, device=dev)
    p["ln_x"] = torch.ones((D,), dtype=dt, device=dev)
    return p


def timemix_axes() -> Dict[str, tuple]:
    return {"mu": (None, "embed"), "w_r": ("embed", "inner"),
            "w_k": ("embed", "inner"), "w_v": ("embed", "inner"),
            "w_g": ("embed", "inner"), "w_w": ("embed", "inner"),
            "w_o": ("inner", "embed"), "u": ("inner_heads", None),
            "ln_x": ("inner",)}


def _timemix_project(p: Params, x, xprev, H, P):
    diff = xprev - x
    mix = lambda i: x + diff * p["mu"][i]                     # noqa: E731
    r = split_heads(mix(0) @ p["w_r"], H, P)
    k = split_heads(mix(1) @ p["w_k"], H, P)
    v = split_heads(mix(2) @ p["w_v"], H, P)
    g = F.silu(mix(3) @ p["w_g"])
    w = torch.exp(-torch.exp(split_heads((mix(4) @ p["w_w"]).float(), H, P)
                             - 3.0))
    return r, k, v, g, w


def timemix_apply(p: Params, x, cfg: ArchConfig, last, chunk: int = 64,
                  unroll: bool = False):
    """x: (B, S, D); last: (B, D) shift state.  Returns (y, new_last, M)."""
    B, S, D = x.shape
    P = cfg.ssm_head_dim
    H = D // P
    r, k, v, g, w = _timemix_project(p, x, _shift(x, last), H, P)
    if unroll:
        wkv = wkv_associative
    else:
        wkv = lambda *a: wkv_chunked(*a, chunk=chunk,      # noqa: E731
                                     remat=cfg.remat)
    if is_dtensor(r):
        wkv = batch_local(wkv, 2, replicated=(4,))
    y, M = wkv(r, k, v, w, p["u"])
    y = L.rms_norm(y.reshape(B, S, D).to(x.dtype), p["ln_x"], cfg.norm_eps)
    return (y * g) @ p["w_o"], x[:, -1], M


def timemix_decode(p: Params, x, cfg: ArchConfig, last, M):
    """x: (B, D).  One step of :func:`wkv_scan_ref`, advancing ``M``
    (B, H, P, P) float32 in place (it may be a view of a cache).  Returns
    (y, new_last, M)."""
    B, D = x.shape
    P = cfg.ssm_head_dim
    H = D // P
    r, k, v, g, w = _timemix_project(p, x, last, H, P)
    kf = k.float()
    step = _wkv_step
    if is_dtensor(M):
        # in place on each rank's rows and heads of the cache's state
        rows = keep_shards(M.placements, (0, 1))
        step = on_shards(_wkv_step, (M.placements,) + (rows,) * 5, (rows,))
    y = step(M, r.float(), p["u"] * kf, kf, v.float(), w)
    y = L.rms_norm(y.reshape(B, D).to(x.dtype), p["ln_x"], cfg.norm_eps)
    return (y * g) @ p["w_o"], x, M


def chanmix_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    D, F_ = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    return {
        "mu": torch.full((2, D), 0.5, dtype=dt, device=generator.device),
        "w_k": L.dense_init(generator, (D, F_), 0, dt),
        "w_v": L.dense_init(generator, (F_, D), 0, dt),
        "w_r": L.dense_init(generator, (D, D), 0, dt),
    }


def chanmix_axes() -> Dict[str, tuple]:
    return {"mu": (None, "embed"), "w_k": ("embed", "ffn"),
            "w_v": ("ffn", "embed"), "w_r": ("embed", "inner")}


def chanmix_apply(p: Params, x, last):
    """x: (B, S, D) with ``last`` (B, D) the shift state, or one token
    (B, D) with ``last`` its predecessor.  Returns (y, new_last)."""
    xprev = _shift(x, last) if x.dim() == 3 else last
    diff = xprev - x
    xk = x + diff * p["mu"][0]
    xr = x + diff * p["mu"][1]
    k = torch.square(F.relu(xk @ p["w_k"]))
    new_last = x[:, -1] if x.dim() == 3 else x
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), new_last


class RWKV6Model(ZooModel):
    """RWKV6 decoder (the family ``ssm`` with ``ssm_state == 0``), the same
    API as ``TransformerModel``:

      RWKV6Model(cfg, device=None)  CUDA unless ``device`` names another
      init(generator) -> self
      forward(inputs) -> logits (B, S, V)
      init_cache(batch, max_len) -> {"M", "last_t", "last_c", "len"}
                                    (max_len unused)
      prefill(inputs, max_len) -> (last-token logits, cache)
      decode(cache, inputs) -> (logits, cache)  M, last_t, last_c in place
    """

    def init(self, generator: torch.Generator) -> "RWKV6Model":
        """Random weights (the reference's initializers) drawn from
        ``generator``, which must live on the model's device."""
        cfg = self.cfg
        self._check_generator(generator)
        with torch.device(self.device):
            layers = [{"ln1": torch.ones((cfg.d_model,), dtype=cfg.pdtype),
                       "ln2": torch.ones((cfg.d_model,), dtype=cfg.pdtype),
                       "time": timemix_init(generator, cfg),
                       "chan": chanmix_init(generator, cfg)}
                      for _ in range(cfg.num_layers)]
            top = self._top_init(generator)
        return self.set_params(layers, top)

    def layer_axes(self) -> Dict:
        return {"ln1": ("embed",), "ln2": ("embed",),
                "time": timemix_axes(), "chan": chanmix_axes()}

    def cache_logical_axes(self) -> Dict:
        return {"M": ("layer", "batch", "inner_heads", None, None),
                "last_t": ("layer", "batch", "embed_act"),
                "last_c": ("layer", "batch", "embed_act"),
                "len": ("batch",)}

    def _layer_apply(self, lp, x):
        """(x after the layer, (M, last_t, last_c))."""
        cfg = self.cfg
        lp = self._gather(lp, self.layer_axes())
        zeros_last = x.new_zeros((x.shape[0], cfg.d_model))
        y, lt, M = timemix_apply(
            lp["time"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
            zeros_last, unroll=not cfg.scan_layers)
        # each block's output is reduced to batch-sharded rows before the
        # residual add: left to DTensor, the residual stream goes sharded
        # over the model axis and the next block's products scatter it over
        # the sequence, which their flattened operands cannot take on fake
        # tensors
        x = x + batch_sharded(y)
        y, lc = chanmix_apply(
            lp["chan"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), zeros_last)
        return x + batch_sharded(y), (M, lt, lc)

    def _layer_out(self, lp, x):
        return self._layer_apply(lp, x)[0]

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            for lp in self.layers:
                x = remat_call(self.cfg.remat, self._layer_out, lp, x)
            return self._head(top, x)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        D = cfg.d_model
        P = cfg.ssm_head_dim
        Lr, dev = cfg.num_layers, self.device
        return {
            "M": torch.zeros((Lr, batch, D // P, P, P), dtype=torch.float32,
                             device=dev),
            "last_t": torch.zeros((Lr, batch, D), dtype=cfg.adtype,
                                  device=dev),
            "last_c": torch.zeros((Lr, batch, D), dtype=cfg.adtype,
                                  device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

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
                x, states = self._layer_apply(lp, x)
                for key, st in zip(("M", "last_t", "last_c"), states):
                    write_(cache[key][i], st)
            cache["len"].fill_(S)
            return self._head(top, x[:, -1]), cache

    @torch.no_grad()
    def decode(self, cache: Cache, inputs: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  inputs: (B,) token ids.  The cache's M and
        shift states are advanced in place (the shift states cast to the
        activation dtype, as the reference casts them); the returned cache
        has ``len`` + 1."""
        with self._dist():
            return self._decode(cache, inputs)

    def _decode(self, cache: Cache, inputs: torch.Tensor):
        cfg = self.cfg
        top = self._top()
        x = self._embed(top, inputs)
        for i, lp in enumerate(self.layers):
            lp = self._gather(lp, self.layer_axes())
            last_t, last_c = cache["last_t"][i], cache["last_c"][i]
            y, lt, _ = timemix_decode(
                lp["time"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                last_t, cache["M"][i])
            x = x + y
            y, lc = chanmix_apply(
                lp["chan"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), last_c)
            x = x + y
            write_(last_t, lt)
            write_(last_c, lc)
        return self._head(top, x), dict(cache, len=cache["len"] + 1)
