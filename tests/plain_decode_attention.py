"""Plain reference of MiniMax-Text-01's softmax-attention decode step.

MiniMax-Text-01 (https://huggingface.co/MiniMaxAI/MiniMax-Text-01, its
``config.json``) has 80 layers; every 8th (``attn_type_list``) is softmax
attention with 64 query heads on 8 KV heads of ``head_dim`` 128, the others
lightning (linear) attention.  At one decode step each softmax layer's new
query attends over every cached position:

    out[h] = softmax(q[h] . K[:, h // G]^T / sqrt(d)) V[:, h // G]

with ``G`` query heads sharing each KV head (GQA).  This file computes that
in plain ``torch``, in float32 with TF32 off, with no kernel, cache manager,
batching or blocking; it imports nothing of the port.

Departures from the published forward pass, each also a departure of the
path under test:

  * q and the cached K are taken as given, after the rotary embedding
    (``rotary_dim`` 64 of 128) and the q/k/v projections; the cache holds
    keys as the model wrote them.
  * the step's new K and V row is not appended: the step reads the cache
    as it is.
  * the output projection, the norms, the MoE and the 70 lightning layers
    are left out: they are not part of the out-of-core attention.
  * heads: any count ``H`` on ``Hkv`` KV heads with ``H % Hkv == 0``, so a
    tensor-parallel chip's share (8 query heads on 1 KV head of each
    layer) is computed as the whole layer is.
"""

import math

import torch


def decode_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """One layer: q (H, d), K and V (S, Hkv, d); returns (H, d) float32."""
    H, d = q.shape
    S, hkv, _ = k.shape
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        qg = q.float().reshape(hkv, H // hkv, d)
        scores = torch.einsum("hgd,shd->hgs", qg, k.float()) / math.sqrt(d)
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("hgs,shd->hgd", p, v.float()).reshape(H, d)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def decode_step(Q: torch.Tensor, K: torch.Tensor,
                V: torch.Tensor) -> torch.Tensor:
    """Every softmax layer of one step: Q (L, H, d), K and V (L, S, Hkv,
    d); returns (L, H, d) float32."""
    return torch.stack([decode_attention(Q[i], K[i], V[i])
                        for i in range(Q.shape[0])])
