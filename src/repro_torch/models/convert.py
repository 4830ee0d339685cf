"""Weights carried across from the reference package.

The reference's models' ``init`` returns a pytree whose layer weights are
stacked on axis 0 (its ``vmap``-ed layer init), and so are Zamba2's shared
blocks (``shared``, axis 0 = ``num_shared_attn_blocks``).  Given that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`load_reference_params` splits each stack into one dict per layer or
block and installs every array, in its own dtype (ml_dtypes ``bfloat16``
becomes ``torch.bfloat16``), on the model's device, so both packages
compute with the same weights.  Nothing of the reference package is
imported.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.runtime import as_tensor


def _tensors(tree: Mapping, device: torch.device, index=None) -> Dict:
    """``tree`` with every array as a tensor on ``device`` (the
    ``index``-th slice of its leading axis when given)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _tensors(v, device, index)
        else:
            a = np.array(v if index is None else v[index])   # a copy
            out[k] = as_tensor(a).to(device).contiguous()
    return out


def load_reference_params(model, params: Mapping):
    """Installs the reference's param tree ``params`` (numpy leaves) into
    ``model`` (a port model of the same config: transformer, Mamba2, RWKV6
    or Zamba2); returns the model."""
    if "layers" not in params:
        raise ValueError(f"not a model's param tree: keys {sorted(params)}")
    cfg = model.cfg
    stacks = {"layers": cfg.num_layers}
    if "shared" in params:
        stacks["shared"] = cfg.num_shared_attn_blocks
    split = {k: [_tensors(params[k], model.device, i) for i in range(n)]
             for k, n in stacks.items()}
    top = _tensors({k: v for k, v in params.items() if k not in stacks},
                   model.device)
    return model.set_params(split.pop("layers"), top, *split.values())
