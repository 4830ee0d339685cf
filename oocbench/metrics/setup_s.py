"""``setup_s``: from the process's start to the window's start: imports,
CUDA's start, the kernels' build or load, the operands, the warm call
(host clock)."""


def read(run):
    return run.setup_s
