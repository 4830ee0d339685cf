"""The comparison that decides ``correct``.

Every call's output gives up ``rows_per_call`` rows, drawn from the seed,
and ``full_per_set`` calls of each operand set, drawn from the seed among
that set's calls (reservoir sampling, so every call is as likely), are kept
whole.  Once the window has closed, the program's state freed and the
memory peak read, the plain reference works out each operand set's answer
again from the same host operands, and each kept row or output is compared
with it.

The number compared is the widest gap, ``max |out - ref| / max |ref|``
over everything kept: the error of the largest entry's scale that the
program's answers show against the reference's.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Tuple

import torch

# rows of a whole output compared at once on the device
BLOCK_BYTES = 256 << 20


class Kept:
    """What the window keeps of its calls' outputs for the comparison."""

    def __init__(self, check: dict, seed: int, n_sets: int):
        self.rows_per_call = int(check["rows_per_call"])
        self.full_per_set = int(check["full_per_set"])
        self.rng = random.Random(f"{seed}:check")
        self.rows: List[Tuple[int, int, torch.Tensor, torch.Tensor]] = []
        self.full: List[List[Tuple[int, torch.Tensor]]] = [
            [] for _ in range(n_sets)]
        self.seen = [0] * n_sets

    def keep(self, call: int, operand_set: int, out: torch.Tensor) -> None:
        n = out.shape[0]
        idx = torch.tensor(sorted(self.rng.sample(
            range(n), min(self.rows_per_call, n))), dtype=torch.long)
        self.rows.append((call, operand_set, idx, out.index_select(0, idx)))
        self.seen[operand_set] += 1
        res = self.full[operand_set]
        if len(res) < self.full_per_set:
            res.append((call, out))
        else:
            j = self.rng.randrange(self.seen[operand_set])
            if j < self.full_per_set:
                res[j] = (call, out)

    def sets(self) -> List[int]:
        return [s for s, n in enumerate(self.seen) if n]


def gap(out: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    """``max |out - ref| / scale`` in float64 on ``ref``'s device; infinite
    for a shape that differs or a value that is not finite."""
    if tuple(out.shape) != tuple(ref.shape):
        return math.inf
    rows = max(1, BLOCK_BYTES // (8 * max(1, ref[0].numel())))
    worst = 0.0
    for r0 in range(0, ref.shape[0], rows):
        d = (out[r0:r0 + rows].to(ref.device, torch.float64)
             - ref[r0:r0 + rows].to(torch.float64)).abs()
        if not bool(torch.isfinite(d).all()):
            return math.inf
        worst = max(worst, float(d.max()))
    return worst / scale


def compare(kept: Kept, reference: Callable[[int], torch.Tensor]
            ) -> Dict[int, float]:
    """Each kept call's widest gap against ``reference(operand_set)``,
    the reference's whole answer for that set (one set at a time)."""
    gaps: Dict[int, float] = {}
    for s in kept.sets():
        ref = reference(s)
        scale = float(ref.abs().max())
        for call, rs, idx, rows in kept.rows:
            if rs == s:
                g = gap(rows, ref.index_select(0, idx.to(ref.device)), scale)
                gaps[call] = max(gaps.get(call, 0.0), g)
        for call, out in kept.full[s]:
            gaps[call] = max(gaps.get(call, 0.0), gap(out, ref, scale))
        del ref
    return gaps
