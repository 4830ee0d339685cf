"""Plain reference of one decode step of attention over a KV cache, the
benchmark's count of its useful work, and its control.

For each layer ``l``: ``softmax(Q[l] K[l]^T / sqrt(d)) V[l]``, each KV head
shared by its group of query heads (GQA).  Plain PyTorch, apart from the
program: float64 on the operands' device, over blocks of positions, in two
passes (every position's score, then the softmax's weights times V).
``control=True`` computes the same from K and V rounded to
``float8_e4m3fn``, the nearest precision below the configuration's
bfloat16 cache, which the comparison has to refuse.
"""

import math

import torch

# positions of K or V held in float64 at once
BLOCK = 1 << 20


def useful_flops(shapes):
    layers, heads, d = shapes["Q"]
    positions = shapes["K"][1]
    return 4 * layers * heads * positions * d


def _rows(x, s0, control):
    blk = x[s0:s0 + BLOCK]
    if control:
        blk = blk.to(torch.float8_e4m3fn)
    return blk.double()


def _layer(q, k, v, control):
    S, hkv, d = k.shape
    qg = q.double().view(hkv, q.shape[0] // hkv, d) / math.sqrt(d)
    scores = torch.cat([torch.einsum("hgd,shd->hgs", qg, _rows(k, s0, control))
                        for s0 in range(0, S, BLOCK)], dim=-1)
    p = torch.softmax(scores, dim=-1)
    del scores
    out = torch.zeros(qg.shape, dtype=torch.float64, device=q.device)
    for s0 in range(0, S, BLOCK):
        out += torch.einsum("hgs,shd->hgd", p[..., s0:s0 + BLOCK],
                            _rows(v, s0, control))
    return out.reshape(q.shape)


def solve(operands, scalars, control=False):
    q, k, v = operands["Q"], operands["K"], operands["V"]
    return torch.stack([_layer(q[layer], k[layer], v[layer], control)
                        for layer in range(q.shape[0])])
