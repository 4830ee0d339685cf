"""Plain reference of the lower Cholesky factor ``L`` of ``A = L L^T``, the
benchmark's count of its useful work, and its control.

Plain PyTorch, apart from the program: ``torch.linalg.cholesky`` in float64
on the operand's device.  ``control=True`` computes the factor in float32
by right-looking blocks whose trailing updates multiply TF32 operands (each
rounded to TF32's 10-bit mantissa, to nearest, and summed in float32, as
the card's TF32 products do): the reference in the nearest precision below
the configuration's float32, which the comparison has to refuse.
"""

import torch

from oocbench.reference.precision import full_float32, tf32

BLOCK = 256


def useful_flops(shapes):
    n = shapes["A"][0]
    return n ** 3 / 3


def _blocked_tf32(a):
    n = a.shape[0]
    b = max(1, min(BLOCK, n // 4))
    L = a.float().clone()
    for k0 in range(0, n, b):
        k1 = min(n, k0 + b)
        L[k0:k1, k0:k1] = torch.linalg.cholesky(L[k0:k1, k0:k1])
        if k1 == n:
            break
        L[k1:, k0:k1] = torch.linalg.solve_triangular(
            L[k0:k1, k0:k1].T, L[k1:, k0:k1], upper=True, left=False)
        p = tf32(L[k1:, k0:k1])
        L[k1:, k1:] -= p @ p.T
    return torch.tril(L)


def solve(operands, scalars, control=False):
    a = operands["A"]
    if not control:
        return torch.linalg.cholesky(a.double())
    with full_float32():
        return _blocked_tf32(a)
