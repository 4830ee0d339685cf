"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same layout as the JAX reference package (``core/``, ``obs/``,
``kernels/``), module for module; hand-written Hopper kernels live under
``csrc/`` and are built with ``nvcc`` at first use.  Nothing here imports
JAX or the reference package.  Entry points run on the CUDA device unless
the caller passes ``torch_device="cpu"``, which runs every kernel's plain
PyTorch version instead.
"""
