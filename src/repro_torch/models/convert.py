"""Weights carried across from the reference package.

The reference's ``TransformerModel.init`` returns a pytree whose layer
weights are stacked on axis 0 (its ``vmap``-ed layer init).  Given that
tree as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`load_reference_params` splits the stack into one dict per layer and
installs every array, in its own dtype (ml_dtypes ``bfloat16`` becomes
``torch.bfloat16``), on the model's device, so both packages compute with
the same weights.  Nothing of the reference package is imported.
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
    ``model`` (a :class:`~repro_torch.models.transformer.TransformerModel`
    of the same config); returns the model."""
    if "layers" not in params:
        raise ValueError(f"not a transformer param tree: keys "
                         f"{sorted(params)}")
    n = model.cfg.num_layers
    layers = [_tensors(params["layers"], model.device, i) for i in range(n)]
    top = _tensors({k: v for k, v in params.items() if k != "layers"},
                   model.device)
    return model.set_params(layers, top)
