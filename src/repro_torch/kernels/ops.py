"""Public kernel wrappers of the port.

Port of ``src/repro/kernels/ops.py``.  There is no ``auto_interpret``: the
tensors' device decides — a CPU tensor runs the plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises.  Decode attention
(``flash_decode_attention``) waits for ROADMAP kernel item 2.
"""

from __future__ import annotations

from repro_torch.kernels.block_matmul import block_matmul

__all__ = ["block_matmul"]
