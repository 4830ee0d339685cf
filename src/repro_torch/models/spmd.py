"""What the sharded models run on DTensors that DTensor cannot place by
itself: plain tensors made inside a model, recurrent scans, in-place state
updates, and head splits.

Port-only.  A sharded model (``models.base.ZooModel.shard``) runs its
entry points under :func:`replicating`, so positions, masks and other
plain tensors take part as replicated DTensors.  What DTensor has no
sharding rule for, or places unevenly, is run here explicitly: the scans
and the decode steps' in-place updates on each rank's own rows and heads
(``local_map``), a head split after replicating a dim sharded across
heads.  None of this falls back to a plain path: an op that DTensor
cannot run raises.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_REPLICATING = threading.local()


@contextlib.contextmanager
def replicating():
    """DTensor's ``implicit_replication``, re-entrant: plain tensors act as
    replicated DTensors until the outermost such context exits."""
    if getattr(_REPLICATING, "on", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _REPLICATING.on = True
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING.on = False


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_sharded(x: torch.Tensor) -> torch.Tensor:
    """An activation with its batch (dim 0) sharded over the mesh's data
    axes and replicated over the rest (the reference's ``batch`` rule); a
    plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          group_placements(x.device_mesh, x.shape[0]))


def group_placements(mesh, n: int) -> tuple:
    """Placements of a tensor whose dim 0 (of size ``n``) holds batch rows
    or token groups: sharded over the data axes where they divide it,
    replicated over the rest."""
    from repro_torch.distributed.sharding import batch_spec, placements
    spec = batch_spec(mesh, 1)
    if n % _axes_product(mesh, spec[0]):
        spec = (None,)
    return placements(spec, mesh)


def keep_shards(placements, dims) -> tuple:
    """``placements`` with every shard of a dim not in ``dims`` replaced by
    ``Replicate()``: the placement of a tensor that shares those leading
    dims (batch rows, heads) with the one placed so."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if isinstance(pl, Shard) and pl.dim in dims
                 else Replicate() for pl in placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; the backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _GradPlacedAsValue(torch.autograd.Function):
    """Identity forward; the backward places a DTensor gradient as the
    value was placed (partial sums as replicated)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_placed_as_value(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient arrives placed as ``x`` is, where DTensor's
    own choice on a (pod, data, model) mesh goes wrong: a split's input
    gradient sharded over the sequence (the weight gradient's product
    then takes a strided sharding of the flattened (B * S) dim that
    DTensor cannot place on fake tensors), a loss's gradient sharded
    over "pod" alone (replicated over the data axis), or the partial sums
    of a vocab-sharded embedding's gradient (the backward of the
    redistribution from its masked partials cannot take a partial
    gradient: DTensor's rule)."""
    return _GradPlacedAsValue.apply(x) \
        if is_dtensor(x) and x.requires_grad else x


def on_shards(fn, in_placements, out_placements, in_grad_placements=None):
    """``fn`` run on each rank's shards (``local_map``): its DTensor
    arguments are redistributed to ``in_placements`` (``None`` for a
    non-tensor), its outputs come back as DTensors placed by
    ``out_placements`` (one per output); ``in_grad_placements`` places the
    arguments' gradients (default: as the arguments).

    The gradients ``fn``'s backward gives its local arguments are made
    contiguous before they become DTensors again: DTensor takes a shard's
    strides to follow its global, contiguous layout, and decides a later
    ``reshape`` (a view) by those; an einsum's gradient may come out
    transposed (a rank's one head of q: (B, S, d) with S innermost), which
    no view can flatten."""
    from torch.distributed.tensor.experimental import local_map

    def local(*args):
        return fn(*(_ContiguousGrad.apply(a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return local_map(local, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     redistribute_inputs=True)


def batch_local(fn, n_out: int, replicated=()):
    """``fn`` on DTensors whose dim 0 is the batch, run on each rank's
    batch rows (the recurrent scans: rows are independent): the arguments
    are placed as the batch is (``group_placements``), except those at
    the indices in ``replicated`` (weights without a batch dim), whose
    gradients are each rank's partial sums over its rows."""
    def run(*args):
        from torch.distributed.tensor import Partial, Replicate, Shard
        x = next(a for a in args if is_dtensor(a))
        mesh = x.device_mesh
        g = group_placements(mesh, x.shape[0])
        rep = (Replicate(),) * mesh.ndim
        part = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in g)
        ins = tuple(None if a is None else rep if i in replicated else g
                    for i, a in enumerate(args))
        grads = tuple(None if a is None else part if i in replicated else g
                      for i, a in enumerate(args))
        return on_shards(fn, ins, (g,) * n_out, grads)(*args)
    return run


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d).  A DTensor sharded along its last dim
    over more ways than divide ``n`` is first replicated along it (a head
    is never split across ranks)."""
    if is_dtensor(x):
        last = x.dim() - 1
        ways = 1
        for i, p in enumerate(x.placements):
            if getattr(p, "dim", None) == last and p.is_shard():
                ways *= x.device_mesh.size(i)
        if n % ways:
            x = x.redistribute(x.device_mesh,
                               keep_shards(x.placements, range(last)))
    return x.reshape(*x.shape[:-1], n, d)


def write_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``; a DTensor ``src`` is first placed as ``dst``."""
    if is_dtensor(dst) and is_dtensor(src):
        src = src.redistribute(dst.device_mesh, dst.placements)
    return dst.copy_(src)


def write_prefix_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[:, :S] = src`` for a fresh (zero) cache ``dst`` (B, Smax,
    ...) and ``src`` (B, S, ...).  A DTensor ``dst`` may be sharded along
    its sequence, which no slice of it can take: ``src`` is zero-padded to
    Smax and written whole (:func:`write_`)."""
    if not is_dtensor(dst):
        dst[:, :src.shape[1]] = src
        return dst
    pad = dst.shape[1] - src.shape[1]
    if pad:
        src = torch.nn.functional.pad(
            src, (0, 0) * (src.dim() - 2) + (0, pad))
    return write_(dst, src)


def _axes_product(mesh, entry) -> int:
    from repro_torch.distributed.sharding import mesh_shape
    shape = mesh_shape(mesh)
    n = 1
    for a in ((entry,) if isinstance(entry, str) else entry or ()):
        n *= shape[a]
    return n


def head_placements(mesh, rows: int, heads, dim: int) -> tuple:
    """Placements of activations whose dim 0 holds ``rows`` batch rows and
    whose dim ``dim`` holds heads (of every count in ``heads``, e.g. the
    query and KV heads): the rows as the batch is placed, the heads sharded
    over each other mesh axis whose size divides every count (so a rank's
    query heads attend to its own KV heads), replicated otherwise."""
    from torch.distributed.tensor import Shard
    out = list(group_placements(mesh, rows))
    for i, pl in enumerate(out):
        if not pl.is_shard() and all(n % mesh.size(i) == 0 for n in heads):
            out[i] = Shard(dim)
    return tuple(out)
