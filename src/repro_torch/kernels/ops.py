"""Public kernel wrappers of the port.

Port of ``src/repro/kernels/ops.py``.  There is no ``auto_interpret``: the
tensors' device decides — a CPU tensor runs the plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises.
"""

from __future__ import annotations

from repro_torch.kernels.block_matmul import block_matmul
from repro_torch.kernels.flash_attention import flash_decode_attention

__all__ = ["block_matmul", "flash_decode_attention"]
