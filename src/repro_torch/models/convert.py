"""Weights carried across from the reference package.

The reference's models' ``init`` returns a pytree whose layer weights are
stacked on axis 0 (its ``vmap``-ed layer init), and so are Zamba2's shared
blocks (``shared``, axis 0 = ``num_shared_attn_blocks``).  Given that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`load_reference_params` splits each stack into one dict per layer or
block and installs every array, in its own dtype (ml_dtypes ``bfloat16``
becomes ``torch.bfloat16``), on the model's device, so both packages
compute with the same weights.  :func:`load_reference_train_state` does
the same for the reference's train state, the optimizer's moments and
master copy keyed by the port's parameter names.  Nothing of the reference
package is imported.
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


def _split(cfg, tree: Mapping, device: torch.device) -> Dict:
    """A param-shaped tree of the reference as {"layers": [one dict per
    layer], "top": {...}} and, for Zamba2, "shared": [one per block]."""
    if "layers" not in tree:
        raise ValueError(f"not a model's param tree: keys {sorted(tree)}")
    stacks = {"layers": cfg.num_layers}
    if "shared" in tree:
        stacks["shared"] = cfg.num_shared_attn_blocks
    out = {k: [_tensors(tree[k], device, i) for i in range(n)]
           for k, n in stacks.items()}
    out["top"] = _tensors({k: v for k, v in tree.items()
                           if k not in stacks}, device)
    return out


def load_reference_params(model, params: Mapping):
    """Installs the reference's param tree ``params`` (numpy leaves) into
    ``model`` (a port model of the same config: transformer, Mamba2, RWKV6
    or Zamba2); returns the model."""
    split = _split(model.cfg, params, model.device)
    shared = (split["shared"],) if "shared" in split else ()
    return model.set_params(split["layers"], split["top"], *shared)


def by_param_name(model, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A param-shaped tree of the reference keyed by the port's parameter
    names (``layers.0.attn.wq``, ``top.embed``, ``shared.1.mlp.w_up``)."""
    def flat(prefix, t):
        for k, v in t.items():
            if isinstance(v, Mapping):
                yield from flat(f"{prefix}{k}.", v)
            else:
                yield f"{prefix}{k}", v

    split = _split(model.cfg, tree, model.device)
    out = dict(flat("top.", split.pop("top")))
    for stack, items in split.items():
        for i, t in enumerate(items):
            out.update(flat(f"{stack}.{i}.", t))
    names = [n for n, _ in model.named_parameters()]
    if sorted(out) != sorted(names):
        raise ValueError(f"the tree's leaves {sorted(out)} are not the "
                         f"model's parameters {sorted(names)}")
    return {n: out[n] for n in names}


def load_reference_train_state(model, state: Mapping) -> Dict:
    """The reference's train state ``{"params", "opt": {"m", "v", "count"
    [, "master"]}}`` (numpy leaves, layers stacked on axis 0) as the port's
    (``training.steps``): the params installed into ``model`` and the
    optimizer's trees keyed by its parameter names, on its device."""
    load_reference_params(model, state["params"])
    ref = state["opt"]
    opt = {"m": by_param_name(model, ref["m"]),
           "v": by_param_name(model, ref["v"]),
           "count": torch.tensor(int(ref["count"]), dtype=torch.int32,
                                 device=model.device)}
    if "master" in ref:
        opt["master"] = by_param_name(model, ref["master"])
    return {"params": dict(model.named_parameters()), "opt": opt}
