"""Logical-axis sharding rules (MaxText-style) and their placements on a
``torch.distributed`` device mesh.

Port of ``src/repro/distributed/sharding.py``.  Every parameter, cache and
activation declares *logical* axis names; this module resolves them to a
:class:`PartitionSpec` (one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of them) and from that to DTensor placements on a
``DeviceMesh``.  The strategy is FSDP x TP:

  * ``batch``           -> ("pod", "data")  (pure DP across pods)
  * weight "width" dims (vocab / heads / ffn / experts / inner) -> "model"
  * weight "depth" dim  (embed) -> "data"   (FSDP: 2-D sharded weights,
    gathered over the data axes at the point of use, :func:`make_weight_gather`)
  * ``cache_seq``       -> "model" fallback when kv_heads can't use it

A dim is sharded only if (a) its size divides the mesh axes' product and
(b) no earlier (higher-priority) dim of the same tensor already took one
of those mesh axes.

``logical_to_spec`` takes a ``DeviceMesh`` or any object whose ``.shape``
maps axis names to sizes (a duck-typed mesh).  :func:`placements` turns a
spec into one placement per mesh dim: a tensor dim sharded over several
mesh axes (``("pod", "data")``) is ``Shard(dim)`` on each of them, the
outer axis first, which is how JAX lays such a dim out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

# (logical name, mesh axes, priority): a lower priority number wins an axis
DEFAULT_RULES: Dict[str, Tuple[Tuple[str, ...], int]] = {
    "batch": (("pod", "data"), 0),
    "vocab": (("model",), 0),
    "heads": (("model",), 0),
    "kv_heads": (("model",), 0),
    "ffn": (("model",), 0),
    "experts": (("model",), 0),
    "inner": (("model",), 0),
    "inner_heads": (("model",), 0),
    "embed": (("data",), 1),       # FSDP dim; loses "data" ties to batch
    "cache_seq": (("model",), 2),  # fallback consumer of "model"
    "assign": (("model",), 0),     # MoE dispatch assignment dim (sorted)
    "embed_act": ((), 9),
    "layer": ((), 9),
}

# Serving rules: weights TP-sharded only ("embed" not sharded over data),
# so no per-step FSDP gather is needed.
SERVE_RULES: Dict[str, Tuple[Tuple[str, ...], int]] = {
    **DEFAULT_RULES, "embed": ((), 9),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of mesh axis names (sharded over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (whose ``.shape`` is a tuple,
    named by ``mesh_dim_names``) or of a duck-typed mesh whose ``.shape``
    is that mapping already."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("the mesh has no axis names (mesh_dim_names)")
    return dict(zip(names, tuple(shape)))


def _axes_size(shape: Mapping[str, int], axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def logical_to_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                    mesh, rules: Optional[Dict] = None) -> PartitionSpec:
    """Resolve one tensor's logical axes to a PartitionSpec."""
    rules = rules or DEFAULT_RULES
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical axes {tuple(logical)} for "
                         f"a {len(shape)}-dim shape {tuple(shape)}")
    ms = mesh_shape(mesh)
    order = sorted(
        range(len(logical)),
        key=lambda i: rules.get(logical[i], ((), 9))[1] if logical[i] else 9)
    used = set()
    out: list = [None] * len(logical)
    for i in order:
        name = logical[i]
        if name is None or name not in rules:
            continue
        axes = tuple(a for a in rules[name][0] if a in ms)
        if not axes or any(a in used for a in axes):
            continue
        if shape[i] % _axes_size(ms, axes):
            continue  # not divisible: replicate rather than pad
        out[i] = axes if len(axes) > 1 else axes[0]
        used.update(axes)
    return PartitionSpec(*out)


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names / ``None``."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _shape_of(x) -> Tuple[int, ...]:
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return tuple(int(n) for n in x)


def _map2(fn, axes_tree, other):
    """``fn(axes, leaf)`` over an axes tree and a tree of its structure
    (dicts and lists; ``other``'s leaves are tensors or shapes)."""
    if is_axes(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, Mapping):
        if set(axes_tree) != set(other):
            raise ValueError(f"tree keys differ: {sorted(axes_tree)} vs "
                             f"{sorted(other)}")
        return {k: _map2(fn, axes_tree[k], other[k]) for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        if len(axes_tree) != len(other):
            raise ValueError(f"tree lengths differ: {len(axes_tree)} vs "
                             f"{len(other)}")
        return type(axes_tree)(_map2(fn, a, o)
                               for a, o in zip(axes_tree, other))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def tree_specs(axes_tree, shape_tree, mesh, rules=None):
    """(logical-axes tree, tree of tensors or shapes) -> PartitionSpecs."""
    return _map2(lambda ax, s: logical_to_spec(ax, _shape_of(s), mesh, rules),
                 axes_tree, shape_tree)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec's DTensor placements on ``mesh`` (a ``DeviceMesh``): for each
    mesh dim, ``Shard(i)`` for the tensor dim ``i`` sharded over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def tree_shardings(axes_tree, shape_tree, mesh, rules=None):
    """(logical-axes tree, tree of tensors or shapes) -> per-leaf DTensor
    placements on ``mesh`` (a ``DeviceMesh``)."""
    return _map2(lambda ax, s: placements(
        logical_to_spec(ax, _shape_of(s), mesh, rules), mesh),
        axes_tree, shape_tree)


def distribute(x: torch.Tensor, mesh, place) -> torch.Tensor:
    """``x`` as a DTensor with placements ``place`` on ``mesh``: every rank
    passes the same full tensor and keeps its shard, with no collective
    (``src_data_rank=None``: no rank's copy is broadcast over the others');
    a DTensor is redistributed instead."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    return distribute_tensor(x, mesh, place, src_data_rank=None)


def constrain(x, logical: Sequence[Optional[str]], mesh, rules=None):
    """The reference's sharding constraint by logical names: ``x`` (a
    DTensor) redistributed to the placement its logical axes resolve to."""
    spec = logical_to_spec(logical, x.shape, mesh, rules)
    return x.redistribute(mesh, placements(spec, mesh))


def make_weight_gather(mesh, rules: Optional[Dict] = None,
                       drop: Tuple[str, ...] = ("data", "pod")):
    """FSDP gather hook: redistributes layer weights to their *model-axis
    only* placement at the point of use.

    Storage stays 2-D sharded (FSDP x TP), but inside a layer the weights
    are all-gathered over the data/pod axes, so the products keep the
    batch sharded instead of reducing activations over ``data``.

    Returns ``gather(tree, axes_tree) -> tree``; a tree's leaves are
    DTensors on ``mesh`` (a plain tensor passes through unchanged).
    """
    base = rules or DEFAULT_RULES
    gr = {k: (tuple(a for a in v[0] if a not in drop), v[1])
          for k, v in base.items()}

    def gather(tree, axes_tree):
        from torch.distributed.tensor import DTensor

        def one(ax, w):
            if not isinstance(w, DTensor):
                return w
            return w.redistribute(mesh, placements(
                logical_to_spec(ax, w.shape, mesh, gr), mesh))

        return _map2(one, axes_tree, tree)

    return gather


def batch_spec(mesh, ndim: int, rules=None) -> PartitionSpec:
    """Spec for an input batch tensor: shard dim 0 on ("pod", "data")."""
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return PartitionSpec(axes if len(axes) > 1 else
                         (axes[0] if axes else None), *([None] * (ndim - 1)))
