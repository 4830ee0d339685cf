"""Plain reference of ``C = alpha A B + beta C``, the benchmark's count of
its useful work, and its control.

Plain PyTorch, apart from the program: float32 products with TF32 off on
the operands' device, a block of rows at a time.  ``control=True`` computes
the same in TF32 (each operand rounded to TF32's 10-bit mantissa, to
nearest, then multiplied and summed in float32, as the card's TF32 products
do), the nearest precision below the configuration's float32, which the
comparison has to refuse.
"""

import torch

from oocbench.reference.precision import full_float32, tf32

ROWS = 4096


def useful_flops(shapes):
    (m, k), (_, n) = shapes["A"], shapes["B"]
    return 2 * m * n * k


def solve(operands, scalars, control=False):
    a, b = operands["A"].float(), operands["B"].float()
    c = operands.get("C")
    alpha = float(scalars.get("alpha", 1.0))
    beta = float(scalars.get("beta", 0.0)) if c is not None else 0.0
    if control:
        a, b = tf32(a), tf32(b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    with full_float32():
        for r0 in range(0, a.shape[0], ROWS):
            r1 = r0 + ROWS
            blk = torch.mm(a[r0:r1], b).mul_(alpha)
            if beta:
                blk.add_(c[r0:r1].float(), alpha=beta)
            out[r0:r1] = blk
    return out
