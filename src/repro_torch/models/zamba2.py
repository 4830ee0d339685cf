"""Zamba2: a Mamba2 backbone with *shared* transformer blocks.

Port of ``src/repro/models/zamba2.py``.  A stack of Mamba2 layers; after
every ``shared_attn_every`` of them, one of ``num_shared_attn_blocks`` full
transformer blocks (attention + gated MLP, weights shared across the sites
that use it, taken round-robin) runs on the hidden state.  The layout is
``n_sites`` sites over the first ``main`` layers, then a ``tail`` of
layers with no site after them (zamba2-1.2b: 6 sites over 36 layers, a
tail of 2).

Faithful simplification (the reference's DESIGN.md §5): the shared block
consumes the hidden state directly.

Decode state: per-layer Mamba2 (h, conv), advanced in place, and per-site
K/V caches (sites, B, Smax, Hkv, d).  Each site's decode attention is
``layers.attention_decode_apply`` on views of its site's caches: the new
token's K/V are written in place and the attention runs kernel 2 on a
card.  The reference's sharding axes and ``weight_gather`` hook: each
Mamba2 layer's and each site's shared block's weights are gathered at
their point of use, as are the embedding and head.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as MB
from repro_torch.models.base import (ZooModel, param_dict, remat,
                                    stack_axes)
from repro_torch.models.spmd import write_, write_prefix_

Cache = Dict[str, torch.Tensor]


class Zamba2Model(ZooModel):
    """The family ``hybrid``, the same API as ``TransformerModel``:

      Zamba2Model(cfg, device=None)  CUDA unless ``device`` names another
      init(generator) -> self
      set_params(layers, top, shared)  one dict per shared block as well
      forward(inputs) -> logits (B, S, V)
      init_cache(batch, max_len) -> {"h", "conv", "k", "v", "len"}
      prefill(inputs, max_len) -> (last-token logits, filled cache)
      decode(cache, inputs) -> (logits, cache)  everything in place
    """

    STACKS = ("layers", "shared")

    def __init__(self, cfg: ArchConfig, device=None, **hooks):
        if cfg.shared_attn_every <= 0:
            raise ValueError(f"{cfg.name}: a hybrid model needs "
                             f"shared_attn_every > 0")
        super().__init__(cfg, device, **hooks)
        every = cfg.shared_attn_every
        self.n_sites = cfg.num_layers // every
        self.main = cfg.num_layers - cfg.num_layers % every
        self.tail = cfg.num_layers - self.main
        self.shared: Optional[nn.ModuleList] = None

    # ------------------------------------------------------------------ init
    def _shared_block_init(self, generator: torch.Generator) -> Dict:
        cfg = self.cfg
        ones = torch.ones((cfg.d_model,), dtype=cfg.pdtype)
        return {
            "attn_norm": ones,
            "mlp_norm": ones.clone(),
            "attn": L.attention_init(generator, cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim_,
                                     cfg.qkv_bias, cfg.pdtype),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, True,
                              cfg.pdtype),
        }

    def init(self, generator: torch.Generator) -> "Zamba2Model":
        """Random weights (the reference's initializers) drawn from
        ``generator``, which must live on the model's device."""
        cfg = self.cfg
        self._check_generator(generator)
        with torch.device(self.device):
            layers = [MB.mamba_layer_init(generator, cfg)
                      for _ in range(cfg.num_layers)]
            shared = [self._shared_block_init(generator)
                      for _ in range(cfg.num_shared_attn_blocks)]
            top = self._top_init(generator)
        return self.set_params(layers, top, shared)

    def set_params(self, layers, top: Dict, shared=()) -> "Zamba2Model":
        """Installs the weights: one dict per Mamba2 layer, the top-level
        ones and one dict per shared block."""
        if len(shared) != self.cfg.num_shared_attn_blocks:
            raise ValueError(f"{len(shared)} shared blocks given, the config "
                             f"has {self.cfg.num_shared_attn_blocks}")
        super().set_params(layers, top)
        self.shared = nn.ModuleList(param_dict(sp) for sp in shared)
        return self

    # -------------------------------------------------------------- sharding
    def layer_axes(self) -> Dict:
        return {"norm": ("embed",), "mamba": MB.mamba_axes(self.cfg)}

    def shared_axes(self) -> Dict:
        return {"attn_norm": ("embed",), "mlp_norm": ("embed",),
                "attn": L.attention_axes(self.cfg.qkv_bias),
                "mlp": L.mlp_axes(True)}

    def param_logical_axes(self) -> Dict:
        return {**super().param_logical_axes(),
                "shared": stack_axes(self.shared_axes())}

    def cache_logical_axes(self) -> Dict:
        kv = ("layer", "batch", "cache_seq", "kv_heads", None)
        return {"h": ("layer", "batch", "inner_heads", None, None),
                "conv": ("layer", "batch", None, "inner"),
                "k": kv, "v": kv, "len": ("batch",)}

    # --------------------------------------------------------------- helpers
    def _site_params(self, site: int):
        """Site ``site``'s shared block, gathered for use."""
        return self._gather(
            self.shared[site % self.cfg.num_shared_attn_blocks],
            self.shared_axes())

    def _layer(self, i: int):
        """Mamba2 layer ``i``, gathered for use."""
        return self._gather(self.layers[i], self.layer_axes())

    def _layer_out(self, i: int, x):
        return MB.mamba_layer_out(self._layer(i), x, self.cfg)

    def _site_layers(self, site: Optional[int]) -> range:
        """The Mamba2 layers before site ``site``, or the tail's (None)."""
        every = self.cfg.shared_attn_every
        if site is None:
            return range(self.main, self.cfg.num_layers)
        return range(site * every, (site + 1) * every)

    def _shared_apply(self, sp, x, positions):
        cfg = self.cfg
        h, kv = L.attention_apply(
            sp["attn"], L.rms_norm(x, sp["attn_norm"], cfg.norm_eps),
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.head_dim_, positions=positions,
            rope_theta=cfg.rope_theta, causal=True, block_q=cfg.block_q)
        x = x + h
        x = x + L.mlp_apply(sp["mlp"],
                            L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps))
        return x, kv

    def _shared_out(self, site: int, x, positions):
        return self._shared_apply(self._site_params(site), x, positions)[0]

    def _run(self, x, cache: Optional[Cache] = None):
        """The whole stack on (B, S, D); with ``cache``, each layer's state
        and each site's K/V are written into it.  Without, under a recorded
        ``forward`` with ``cfg.remat``, each Mamba2 layer and each site's
        shared block is rematerialised in the backward on its own, as in
        the reference (whose sites sit outside its layer scans)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        for site in [*range(self.n_sites), None]:
            for i in self._site_layers(site):
                if cache is None:
                    x = remat(cfg.remat, self._layer_out, i, x)
                    continue
                x, h, conv = MB.mamba_layer_apply(self._layer(i), x, cfg)
                write_(cache["h"][i], h)
                write_(cache["conv"][i], conv)
            if site is None:
                break
            if cache is None:
                x = remat(cfg.remat, self._shared_out, site, x, positions)
                continue
            sp = self._site_params(site)
            x, (k, v) = self._shared_apply(sp, x, positions)
            write_prefix_(cache["k"][site], k)
            write_prefix_(cache["v"][site], v)
        return x

    # --------------------------------------------------------------- forward
    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        with self._dist():
            top = self._top()
            return self._head(top, self._run(self._embed(top, inputs)))

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        kv = (self.n_sites, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
        kw = dict(dtype=cfg.adtype, device=self.device)
        cache = MB.mamba_cache(cfg, batch, self.device)
        cache["k"] = torch.zeros(kv, **kw)
        cache["v"] = torch.zeros(kv, **kw)
        return cache

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process a full prompt; return (last-token logits, filled cache
        of ``max(max_len, S)`` positions per site)."""
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            B, S = x.shape[:2]
            cache = self._prefill_cache(B, max(max_len or S, S))
            x = self._run(x, cache)
            cache["len"].fill_(S)
            return self._head(top, x[:, -1]), cache

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, cache: Cache, inputs: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  inputs: (B,) token ids.  The Mamba2 states and
        the sites' K/V are written in place; the returned cache has
        ``len`` + 1."""
        with self._dist():
            return self._decode(cache, inputs)

    def _decode(self, cache: Cache, inputs: torch.Tensor):
        cfg = self.cfg
        top = self._top()
        x = self._embed(top, inputs)
        length = cache["len"]
        for site in [*range(self.n_sites), None]:
            for i in self._site_layers(site):
                x = MB.mamba_layer_decode(self._layer(i), x, cache["h"][i],
                                          cache["conv"][i], cfg)
            if site is None:
                break
            sp = self._site_params(site)
            xn = L.rms_norm(x, sp["attn_norm"], cfg.norm_eps)
            x = x + L.attention_decode_apply(
                sp["attn"], xn, cache["k"][site], cache["v"][site], length,
                n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)
            x = x + L.mlp_apply(sp["mlp"],
                                L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps))
        return self._head(top, x), dict(cache, len=length + 1)
