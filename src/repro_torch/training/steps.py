"""Arch-agnostic train and serve step builders.

Port of ``src/repro/training/steps.py``.  The train state is
``{"params": {name: parameter}, "opt": adamw state}``: ``params`` holds
the model's own parameters (``dict(model.named_parameters())``), so a
step that updates the state in place updates the model.
``build_train_step`` assembles the reference's step: microbatched gradient
accumulation in float32, the float32 cross-entropy, global-norm clipping
and AdamW.  The serving steps wrap the model's entry points.
``train_state_logical_axes`` gives the state's logical axes, in the
reference's layout or by parameter name (the port's state).  On a sharded
model (``ZooModel.shard``) the state's tensors are DTensors and the step
runs on them as it stands (``launch.train``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, float32 logsumexp.  The label's logit is
    picked by index: the reference contracts a one-hot instead (for its
    vocab-sharded logits), which gives the same value."""
    from repro_torch.models.spmd import grad_placed_as_value, is_dtensor
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # on vocab-sharded logits the label's logit is a masked sum (the
        # reference's one-hot contraction; the same value), which stays
        # local to each shard
        hit = torch.arange(logits.shape[-1], device=logits.device) \
            == labels.long().unsqueeze(-1)
        ll = torch.where(hit, logits, 0.0).sum(-1)
        # the mean's gradient placed as the (B, S) losses are: left to
        # DTensor on a (pod, data, model) mesh, it comes back sharded over
        # "pod" only, and the masked sum's backward then holds a (B / 2,
        # S, V) float32 gradient on every rank
        return grad_placed_as_value(lse - ll).mean()
    ll = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (lse - ll).mean()


def build_loss_fn(model) -> Callable:
    def loss_fn(batch):
        with model._dist():
            return cross_entropy(model.forward(batch["inputs"]),
                                 batch["labels"].to(model.device))
    return loss_fn


def train_state(model, opt_cfg: Optional[adamw.AdamWConfig] = None
                ) -> Dict:
    """The train state of ``model``'s current weights: its parameters by
    name and a fresh optimizer state."""
    params = dict(model.named_parameters())
    use_master = opt_cfg.use_master if opt_cfg else True
    return {"params": params, "opt": adamw.init(params, use_master)}


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: Optional[adamw.AdamWConfig] = None) -> Dict:
    """Random weights drawn from ``generator`` (on the model's device), and
    their train state."""
    model.init(generator)
    return train_state(model, opt_cfg)


def train_state_logical_axes(model, use_master: bool = True,
                             by_name: bool = False) -> Dict:
    """The train state's logical axes: the reference's tree
    (``param_logical_axes``), or with ``by_name`` the port's state keyed by
    parameter name (``named_logical_axes``)."""
    pax = model.named_logical_axes() if by_name else \
        model.param_logical_axes()
    return {"params": pax,
            "opt": adamw.state_logical_axes(pax, use_master)}


def shard_train_state(model, mesh, opt_cfg: Optional[adamw.AdamWConfig]
                      = None, rules=None) -> Dict:
    """``model``'s weights placed on ``mesh`` (``ZooModel.shard``) and their
    train state, every leaf a DTensor placed by ``tree_shardings`` of
    ``train_state_logical_axes`` (the optimizer's moments and master copy
    as their parameters, the step count replicated)."""
    from repro_torch.distributed.sharding import distribute, tree_shardings

    model.shard(mesh, rules)
    state = train_state(model, opt_cfg)
    use_master = opt_cfg.use_master if opt_cfg else True
    places = tree_shardings(
        train_state_logical_axes(model, use_master, by_name=True), state,
        mesh, rules)
    for name, p in state["params"].items():
        if tuple(p.placements) != places["params"][name]:
            raise AssertionError(f"{name} placed {p.placements}, the rules "
                                 f"give {places['params'][name]}")

    def place(tree, pl):
        if isinstance(tree, dict):
            return {k: place(v, pl[k]) for k, v in tree.items()}
        return distribute(tree, mesh, pl)

    state["opt"] = place(state["opt"], places["opt"])
    return state


def build_train_step(model, opt_cfg: adamw.AdamWConfig, microbatch: int = 1,
                     unroll: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds ``inputs`` and ``labels`` tensors (moved to the model's device).
    With ``microbatch`` > 1 the batch is split into that many consecutive
    slices whose gradients are summed in float32 and divided by
    ``microbatch``, and the loss is their losses' mean, as the reference's
    ``lax.scan`` does (``unroll``, the reference's choice between the scan
    and a Python loop, changes nothing here: the port always loops).  The
    state is updated in place; metrics are ``loss``, ``grad_norm`` and
    ``lr``, 0-dim float32 tensors on the device."""
    loss_fn = build_loss_fn(model)

    def value_and_grad(params, batch):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        # a weight the forward never reads (a stub-frontend arch's token
        # embedding) has a zero gradient, as in the reference
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params.values(), grads)]

    def train_step(state, batch):
        with model._dist():
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        if microbatch > 1:
            b = batch["inputs"].shape[0]
            if b % microbatch:
                raise ValueError(f"a batch of {b} does not split into "
                                 f"{microbatch} microbatches")
            n = b // microbatch
            losses, acc = [], None
            for i in range(microbatch):
                loss, g = value_and_grad(
                    params, {k: x[i * n:(i + 1) * n]
                             for k, x in batch.items()})
                losses.append(loss)
                g = [gi.float() for gi in g]
                if acc is None:
                    acc = g
                else:
                    torch._foreach_add_(acc, g)
            torch._foreach_div_(acc, float(microbatch))
            grads, loss = acc, torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(params, batch)
        _, opt, metrics = adamw.update(dict(zip(params, grads)),
                                       state["opt"], params, opt_cfg)
        return {"params": params, "opt": opt}, dict(metrics, loss=loss)

    return train_step


def build_forward_step(model) -> Callable:
    return build_loss_fn(model)


def build_prefill_step(model, max_len: Optional[int] = None,
                       cache_shardings: Optional[Dict] = None) -> Callable:
    """``prefill_step(inputs) -> (logits, cache)``.  With
    ``cache_shardings`` (the cache's placements on the model's mesh, e.g.
    ``tree_shardings`` of ``cache_logical_axes``, as the reference's
    ``out_shardings``) the cache comes out placed so: batch rows, KV heads
    or, where the KV heads do not divide the model axis, the sequence."""
    def prefill_step(inputs):
        logits, cache = model.prefill(inputs, max_len=max_len)
        if cache_shardings is not None:
            from repro_torch.distributed.sharding import distribute
            cache = {k: distribute(v, model.mesh, cache_shardings[k])
                     for k, v in cache.items()}
        return logits, cache
    return prefill_step


def build_decode_step(model) -> Callable:
    def decode_step(cache, inputs):
        return model.decode(cache, inputs)
    return decode_step
