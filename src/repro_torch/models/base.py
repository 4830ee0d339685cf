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

Sharding (the reference's hooks and logical axes): a model takes the
reference's ``shard_ec``, ``shard_assign`` and ``weight_gather`` hooks
(``distributed.make_weight_gather``), and each family declares its
``layer_axes`` and ``param_logical_axes`` in the reference's layout (the
layers stacked under ``"layers"`` with a leading ``"layer"`` axis);
:meth:`ZooModel.named_logical_axes` gives them by parameter name, and
:meth:`ZooModel.shard` places the weights as DTensors on a ``DeviceMesh``.
On sharded weights every entry point runs on DTensors: the weights are
gathered at their point of use, the activations keep the batch sharded
over the data axes, and a plain tensor made inside the model (positions,
masks) takes part as a replicated one (``implicit_replication``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.spmd import (batch_sharded, grad_placed_as_value,
                                     is_dtensor, keep_shards, replicating)


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


def stack_axes(tree):
    """Prepends the stacked ``"layer"`` axis to every leaf of an axes tree."""
    if isinstance(tree, dict):
        return {k: stack_axes(v) for k, v in tree.items()}
    return ("layer",) + tuple(tree)


class ZooModel(nn.Module):
    """A model of ``cfg`` on ``device`` (CUDA unless it names another;
    raises without a card), without weights until ``init`` or
    ``models.convert.load_reference_params`` installs them.  The hooks are
    the reference's: ``weight_gather(tree, axes_tree)`` at each layer's
    and the embedding's and head's point of use, ``shard_ec`` and
    ``shard_assign`` on the MoE dispatch's (G, E, C, D) tensors."""

    # the stacked parameter groups ("layers", and Zamba2's "shared")
    STACKS = ("layers",)

    def __init__(self, cfg: ArchConfig, device=None, *, shard_ec=None,
                 weight_gather=None, shard_assign=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "device")
        self.layers: Optional[nn.ModuleList] = None
        self.top: Optional[nn.ParameterDict] = None
        self.shard_ec = shard_ec
        self.shard_assign = shard_assign
        self.weight_gather = weight_gather

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
        if cfg.embedding_input:
            return batch_sharded(inputs.to(self.device).to(cfg.adtype))
        return self._lookup(top, inputs)

    def _lookup(self, top, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids through the embedding table (``F.embedding``, whose
        DTensor rule serves a vocab-sharded table with masked partials),
        in the activation dtype; a sharded table is gathered along its
        embedding dim first and the rows come out batch-sharded."""
        tokens, table = tokens.to(self.device), top["embed"]
        if is_dtensor(table):
            table = table.redistribute(table.device_mesh,
                                       keep_shards(table.placements, (0,)))
        x = torch.nn.functional.embedding(tokens, table)
        return grad_placed_as_value(batch_sharded(x.to(self.cfg.adtype)))

    def _head(self, top, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, top["final_norm"], self.cfg.norm_eps)
        return x @ top["lm_head"].to(x.dtype)

    # -------------------------------------------------------------- sharding
    def _has_embed(self) -> bool:
        return True

    def top_axes(self) -> Dict:
        """The logical axes of the top-level weights."""
        axes = {"final_norm": ("embed",), "lm_head": ("embed", "vocab")}
        if self._has_embed():
            axes["embed"] = ("vocab", "embed")
        return axes

    def param_logical_axes(self) -> Dict:
        """The reference's tree: the layers' axes stacked under "layers"."""
        return {"layers": stack_axes(self.layer_axes()), **self.top_axes()}

    def named_logical_axes(self) -> Dict[str, tuple]:
        """Every parameter's logical axes keyed by its name
        (``layers.0.attn.wq``), the stacked ``"layer"`` axis dropped."""
        def flat(prefix, t):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from flat(f"{prefix}{k}.", v)
                else:
                    yield f"{prefix}{k}", tuple(v)

        axes = self.param_logical_axes()
        out = {}
        for k, v in axes.items():
            if k in self.STACKS:
                for i in range(len(getattr(self, k))):
                    out.update((n, a[1:]) for n, a in flat(f"{k}.{i}.", v))
            else:
                out[f"top.{k}"] = tuple(v)
        return {n: out[n] for n, _ in self.named_parameters()}

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """The cache's shapes and dtypes (tensors on the ``meta`` device)."""
        dev, self.device = self.device, torch.device("meta")
        try:
            return self.init_cache(batch, max_len)
        finally:
            self.device = dev

    def _prefill_cache(self, batch: int, max_len: int) -> Dict:
        """A fresh cache for ``prefill``: on sharded weights its tensors
        are DTensors placed by the rules (``cache_logical_axes``), each
        rank allocating its own shard only."""
        if self.mesh is None:
            return self.init_cache(batch, max_len)
        from torch.distributed.tensor import zeros

        from repro_torch.distributed.sharding import tree_shardings
        specs = self.cache_specs(batch, max_len)
        places = tree_shardings(self.cache_logical_axes(), specs, self.mesh)
        return {k: zeros(v.shape, dtype=v.dtype, device_mesh=self.mesh,
                         placements=places[k]) for k, v in specs.items()}

    @property
    def mesh(self):
        """The ``DeviceMesh`` the weights are sharded on (None if plain)."""
        p = next(iter(self.parameters()), None)
        return p.device_mesh if p is not None and is_dtensor(p) else None

    def shard(self, mesh, rules=None) -> "ZooModel":
        """Places every weight as a DTensor on ``mesh`` by its logical axes
        (``rules``: ``distributed.DEFAULT_RULES`` unless given); every rank
        passes the same weights and keeps its shard.  Returns the model."""
        from repro_torch.distributed.sharding import (distribute,
                                                      logical_to_spec,
                                                      placements)
        axes = self.named_logical_axes()
        for name, p in list(self.named_parameters()):
            owner, leaf = name.rsplit(".", 1)
            spec = logical_to_spec(axes[name], p.shape, mesh, rules)
            self.get_submodule(owner)[leaf] = nn.Parameter(
                distribute(p.detach(), mesh, placements(spec, mesh)),
                requires_grad=p.requires_grad)
        return self

    def _dist(self):
        """The context every entry point runs in: plain tensors made inside
        the model act as replicated DTensors when the weights are sharded."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return replicating()

    def _gather(self, lp, axes: Dict):
        """``weight_gather`` on a layer's (or block's) weights, if set."""
        if self.weight_gather is None:
            return lp
        return self.weight_gather(lp, axes)

    def _top(self):
        """The top-level weights, with ``embed`` and ``lm_head`` gathered
        over the data axes at their point of use (the reference's FSDP
        hook)."""
        top = self._params()
        if self.weight_gather is None:
            return top
        keys = [k for k in ("embed", "lm_head") if k in top]
        axes = self.top_axes()
        return {**dict(top.items()), **self.weight_gather(
            {k: top[k] for k in keys}, {k: axes[k] for k in keys})}
