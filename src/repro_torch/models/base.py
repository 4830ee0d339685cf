"""What every model of the zoo shares: its device, its weights and the
embedding and head around its layers.

Port-only (the reference's models are plain classes over a param pytree).
Each layer's parameters are an ``nn.ParameterDict`` in an ``nn.ModuleList``
and a Python loop runs them; the top-level weights (``embed``,
``final_norm``, ``lm_head``) are one more ``ParameterDict``.  Weights are
trainable parameters: ``forward`` records autograd's graph when gradients
are enabled (the train step), ``prefill`` and ``decode`` never do.  With
``cfg.remat`` each layer of a recorded ``forward`` is rematerialised in the
backward (:func:`remat`), as the reference's ``jax.checkpoint`` does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import resolve_device
from repro_torch.models import layers as L


def param_dict(tree: Dict) -> nn.ParameterDict:
    """A nested dict of tensors as (nested) ParameterDicts of trainable
    parameters."""
    return nn.ParameterDict({
        k: param_dict(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tree.items()})


def remat(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled`` and autograd is recording, its
    activations are not kept for the backward but recomputed there
    (``torch.utils.checkpoint``, non-reentrant): the reference's
    ``jax.checkpoint`` with ``nothing_saveable``."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ZooModel(nn.Module):
    """A model of ``cfg`` on ``device`` (CUDA unless it names another;
    raises without a card), without weights until ``init`` or
    ``models.convert.load_reference_params`` installs them."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "device")
        self.layers: Optional[nn.ModuleList] = None
        self.top: Optional[nn.ParameterDict] = None

    def _check_generator(self, generator: torch.Generator) -> None:
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"model on {self.device}")

    def _top_init(self, generator: torch.Generator, embed: bool = True
                  ) -> Dict:
        """The final norm, the LM head and (with ``embed``) the embedding
        table, drawn with the reference's initializers in that order
        (called under ``torch.device``)."""
        cfg = self.cfg
        top = {
            "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype),
            "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    0, cfg.pdtype),
        }
        if embed:
            top["embed"] = L.embedding_init(generator, cfg.vocab_size,
                                            cfg.d_model, cfg.pdtype)
        return top

    def set_params(self, layers, top: Dict) -> "ZooModel":
        """Installs the weights: one dict per layer (the reference's layer
        tree) and the top-level ``final_norm``, ``lm_head`` and ``embed``."""
        if len(layers) != self.cfg.num_layers:
            raise ValueError(f"{len(layers)} layers given, the config has "
                             f"{self.cfg.num_layers}")
        self.layers = nn.ModuleList(param_dict(lp) for lp in layers)
        self.top = param_dict(top)
        return self

    def _params(self) -> nn.ParameterDict:
        if self.layers is None:
            raise RuntimeError("the model has no weights: call init() or "
                               "models.convert.load_reference_params()")
        return self.top

    def _embed(self, top, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids (any shape) to activations; a stub-frontend arch's
        embeddings pass through in the activation dtype."""
        cfg = self.cfg
        inputs = inputs.to(self.device)
        if cfg.embedding_input:
            return inputs.to(cfg.adtype)
        return top["embed"][inputs].to(cfg.adtype)

    def _head(self, top, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, top["final_norm"], self.cfg.norm_eps)
        return x @ top["lm_head"].to(x.dtype)
