"""The one generator of every traffic mix.

A mix (``traffic/<name>.json``) is data:

  * ``loop``: ``"closed"``, one caller issuing calls back to back;
  * ``operand_sets``: how many sets of operands the seed makes; the calls
    take them in turn, so no call finds the previous call's tensors;
  * ``operands``: by name, a ``shape`` (numbers, or names of keys of the
    configuration, such as ``"n"``) and a ``dist``: ``normal`` (standard
    normal entries) or ``spd_gram`` (``G G^T / n + shift I``, the Gram
    matrix of an ``n x n`` ``G`` of normal entries of mean ``mean`` and
    variance 1, with a ridge: symmetric positive definite, one eigenvalue
    near ``mean^2 n``, the others in about ``[shift, shift + 4]``);
  * ``scalars``: keyword values the entry point takes as they are (such as
    ``alpha`` and ``beta``);
  * ``check``: ``rows_per_call``, the rows of every call's output that are
    compared, drawn from the seed, and ``full_per_set``, how many calls of
    each operand set, drawn from the seed, are compared whole.

Operands are made on ``device`` from the seed, with one generator there, in
the configuration's dtype, and handed over as ordinary (pageable) host
tensors, as a caller's would be.  The same seed makes the same operands;
every seed makes the same shapes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from oocbench.reference.precision import full_float32


def dtype_of(config: dict) -> torch.dtype:
    """The configuration's ``dtype``, named as ``torch`` names it."""
    dt = getattr(torch, str(config["dtype"]), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"dtype {config['dtype']!r} is no floating dtype "
                         f"of torch")
    return dt


def _normal(shape, gen, spec, dtype):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


def _spd_gram(shape, gen, spec, dtype):
    n, n2 = shape
    if n != n2:
        raise ValueError(f"spd_gram needs a square shape, got {shape}")
    g = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32).add_(float(spec.get("mean", 0.0)))
    with full_float32():
        a = g @ g.T
    del g
    a = (a + a.T).mul_(0.5 / n)
    a.diagonal().add_(float(spec.get("shift", 1.0)))
    return a.to(dtype)


DISTS: Dict[str, Callable] = {"normal": _normal, "spd_gram": _spd_gram}


def shape_of(spec: dict, config: dict) -> Tuple[int, ...]:
    return tuple(int(config[d]) if isinstance(d, str) else int(d)
                 for d in spec["shape"])


def shapes(traffic: dict, config: dict) -> Dict[str, Tuple[int, ...]]:
    return {name: shape_of(spec, config)
            for name, spec in traffic["operands"].items()}


def make_sets(traffic: dict, config: dict, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """The mix's operand sets for ``seed``, as host tensors."""
    if traffic.get("loop") != "closed":
        raise ValueError(f"unknown loop {traffic.get('loop')!r}; the "
                         f"generator drives a closed loop")
    dtype = dtype_of(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sets = []
    for _ in range(int(traffic["operand_sets"])):
        ops = {}
        for name, spec in traffic["operands"].items():
            x = DISTS[spec["dist"]](shape_of(spec, config), gen, spec, dtype)
            ops[name] = x.cpu()
            del x
        sets.append(ops)
    return sets
