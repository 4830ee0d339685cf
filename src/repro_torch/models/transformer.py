"""Transformer model: dense decoder, MoE decoder, encoder-only — one class.

Port of ``src/repro/models/transformer.py``.  Covers the eight transformer
archs (qwen2.5, codeqwen1.5, stablelm, llama3.2, the internvl2 backbone,
the hubert encoder, qwen3-moe, deepseek-moe).  Each layer's parameters are
an ``nn.ParameterDict`` in an ``nn.ModuleList`` and a Python loop runs them
(the reference stacks the layers and scans them; ``scan_layers`` has no
effect here).  With ``cfg.remat`` a recorded ``forward`` rematerialises
each layer in the backward, as the reference's ``jax.checkpoint`` does.
Weights keep the reference's ``(in, out)`` layout and are applied as
``x @ W``.

API:
  TransformerModel(cfg, device=None)  CUDA unless ``device`` names another;
                                      raises without a card
  init(generator) -> self             random weights drawn on the device
  forward(inputs) -> logits (B, S, V)
  init_cache(batch, max_len) -> {"k", "v": (L, B, Smax, Hkv, d), "len": (B,)}
  prefill(inputs, max_len) -> (last-token logits, filled cache)
  decode(cache, inputs) -> (logits, cache)
  layer_axes() / param_logical_axes() / cache_logical_axes() -> logical axes
  cache_specs(batch, max_len) -> the cache's shapes (``meta`` tensors)

Weights are loaded with ``init`` or ``models.convert.load_reference_params``
and are trainable: ``forward`` records autograd's graph unless the caller
disables it (serving callers run it under ``torch.inference_mode``);
``prefill`` and ``decode`` never record it.  ``decode``
writes the new token's K/V into the cache tensors in place and returns the
cache with ``len`` advanced; each layer's decode attention is kernel 2 on a
card.  The reference's hooks (``shard_ec``, ``shard_assign``,
``weight_gather``; ``models.base``) run where the reference runs them:
the weight gather on the embedding and head and on each layer's weights,
the MoE hooks in ``forward``'s dispatch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.base import ZooModel, remat
from repro_torch.models.spmd import write_prefix_

Cache = Dict[str, torch.Tensor]


class TransformerModel(ZooModel):
    def _has_embed(self) -> bool:
        # the embedding table exists unless the arch never consumes tokens
        # (an encoder with a stubbed frontend); a causal stub-frontend arch
        # (VLM) still decodes text tokens
        return not self.cfg.embedding_input or self.cfg.causal

    def layer_axes(self) -> Dict:
        cfg = self.cfg
        lp = {"attn_norm": ("embed",), "mlp_norm": ("embed",),
              "attn": L.attention_axes(cfg.qkv_bias)}
        if cfg.is_moe:
            lp["moe"] = M.moe_axes(cfg.num_shared_experts)
        else:
            lp["mlp"] = L.mlp_axes(True)
        return lp

    def cache_logical_axes(self) -> Dict:
        ax = ("layer", "batch", "cache_seq", "kv_heads", None)
        return {"k": ax, "v": ax, "len": ("batch",)}

    # ------------------------------------------------------------------ init
    def _layer_init(self, gen: torch.Generator) -> Dict:
        cfg = self.cfg
        ones = torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=gen.device)
        p = {
            "attn_norm": ones,
            "mlp_norm": ones.clone(),
            "attn": L.attention_init(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim_, cfg.qkv_bias, cfg.pdtype),
        }
        if cfg.is_moe:
            p["moe"] = M.moe_init(gen, cfg.d_model, cfg.d_ff,
                                  cfg.num_experts, cfg.num_shared_experts,
                                  cfg.pdtype)
        else:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, True,
                                  cfg.pdtype)
        return p

    def init(self, generator: torch.Generator) -> "TransformerModel":
        """Random weights (the reference's initializers) drawn from
        ``generator``, which must live on the model's device."""
        cfg = self.cfg
        self._check_generator(generator)
        with torch.device(self.device):
            layers = [self._layer_init(generator)
                      for _ in range(cfg.num_layers)]
            top = self._top_init(generator, embed=self._has_embed())
        return self.set_params(layers, top)

    # ----------------------------------------------------------------- layer
    def _mlp(self, lp, xn: torch.Tensor, groups: Optional[int],
             hooks: bool = True):
        cfg = self.cfg
        if cfg.is_moe:
            return M.moe_apply(lp["moe"], xn, top_k=cfg.num_experts_per_tok,
                               capacity_factor=cfg.capacity_factor,
                               groups=groups,
                               shard_ec=self.shard_ec if hooks else None,
                               shard_rep=self.shard_assign if hooks else None)
        return L.mlp_apply(lp["mlp"], xn, gated=True)

    def _layer_apply(self, lp, x: torch.Tensor, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tuple]:
        cfg = self.cfg
        lp = self._gather(lp, self.layer_axes())
        h, kv = L.attention_apply(
            lp["attn"], L.rms_norm(x, lp["attn_norm"], cfg.norm_eps),
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.head_dim_, positions=positions,
            rope_theta=cfg.rope_theta, causal=cfg.causal,
            block_q=cfg.block_q)
        x = x + h
        y = self._mlp(lp, L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps),
                      cfg.moe_groups)
        return x + y, kv

    # --------------------------------------------------------------- forward
    def _layer_out(self, lp, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        return self._layer_apply(lp, x, positions)[0]

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """Training-shape forward: logits for every position (B, S, V)."""
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            B, S = x.shape[:2]
            positions = torch.arange(S, device=self.device).expand(B, S)
            for lp in self.layers:
                x = remat(self.cfg.remat, self._layer_out, lp, x, positions)
            return self._head(top, x)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        kw = dict(dtype=cfg.adtype, device=self.device)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                "len": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process a full prompt; return (last-token logits, filled cache
        of ``max(max_len, S)`` positions)."""
        with self._dist():
            top = self._top()
            x = self._embed(top, inputs)
            B, S = x.shape[:2]
            positions = torch.arange(S, device=self.device).expand(B, S)
            cache = self._prefill_cache(B, max(max_len or S, S))
            for i, lp in enumerate(self.layers):
                x, (k, v) = self._layer_apply(lp, x, positions)
                write_prefix_(cache["k"][i], k)
                write_prefix_(cache["v"][i], v)
            cache["len"].fill_(S)
            return self._head(top, x[:, -1]), cache

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, cache: Cache, inputs: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  inputs: (B,) token ids.  The caches' K/V are
        written in place; the returned cache has ``len`` + 1."""
        with self._dist():
            return self._decode(cache, inputs)

    def _decode(self, cache: Cache, inputs: torch.Tensor):
        cfg = self.cfg
        top = self._top()
        x = self._lookup(top, inputs)
        length = cache["len"]                                   # (B,)
        for i, lp in enumerate(self.layers):
            lp = self._gather(lp, self.layer_axes())
            xn = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            x = x + L.attention_decode_apply(
                lp["attn"], xn, cache["k"][i], cache["v"][i], length,
                n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)
            xn = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            if cfg.is_moe:
                y = self._mlp(lp, xn[:, None, :], 1, hooks=False)[:, 0]
            else:
                y = self._mlp(lp, xn, None)
            x = x + y
        logits = self._head(top, x)
        return logits, {"k": cache["k"], "v": cache["v"], "len": length + 1}
