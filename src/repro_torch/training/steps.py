"""Arch-agnostic loss and serving step builders.

Port of ``src/repro/training/steps.py`` for the steps that need no
optimizer: the loss, the forward step and the serving steps, which wrap
the model's entry points.  ``build_train_step``, ``init_train_state`` and
``train_state_logical_axes`` need ``optim/`` and gradients: ROADMAP module
item 12c.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, float32 logsumexp.  The label's logit is
    picked by index: the reference contracts a one-hot instead (for its
    vocab-sharded logits), which gives the same value."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (lse - ll).mean()


def build_loss_fn(model) -> Callable:
    def loss_fn(batch):
        return cross_entropy(model.forward(batch["inputs"]),
                             batch["labels"].to(model.device))
    return loss_fn


def build_forward_step(model) -> Callable:
    return build_loss_fn(model)


def build_prefill_step(model, max_len: Optional[int] = None) -> Callable:
    def prefill_step(inputs):
        return model.prefill(inputs, max_len=max_len)
    return prefill_step


def build_decode_step(model) -> Callable:
    def decode_step(cache, inputs):
        return model.decode(cache, inputs)
    return decode_step
