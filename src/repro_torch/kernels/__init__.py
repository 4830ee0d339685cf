"""Hand-written Hopper kernels of the port (sources under ``csrc/``), each
beside its plain PyTorch version; see ``kernels/ops.py`` for the public
wrappers and ``kernels/ref.py`` for the test oracles."""
