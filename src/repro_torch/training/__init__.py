"""Loss, train and serving steps (port of ``src/repro/training``)."""

from repro_torch.training.steps import (
    build_decode_step,
    build_forward_step,
    build_loss_fn,
    build_prefill_step,
    build_train_step,
    cross_entropy,
    init_train_state,
    train_state,
)

__all__ = ["build_decode_step", "build_forward_step", "build_loss_fn",
           "build_prefill_step", "build_train_step", "cross_entropy",
           "init_train_state", "train_state"]
