"""The precisions the references and the generator work in: float32 with
TF32 off, and the rounding of float32 to TF32 that the controls use.

Not an entry point: no configuration names it as its ``entry``."""

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """float32 products without TF32, set back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def tf32(x):
    """``x`` (float32) rounded to TF32, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)
