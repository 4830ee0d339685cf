"""Optimizer and gradient compression (port of ``src/repro/optim``)."""

from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["AdamWConfig", "adamw", "compression"]
