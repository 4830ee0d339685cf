"""Device meshes over ``torch.distributed``, and the process group under
them.

Port of ``src/repro/launch/mesh.py``.  The production and debug meshes are
shape and axis-name tables; :func:`make_mesh` builds a ``DeviceMesh`` of a
table only when the world's size is the table's (it raises otherwise,
naming both), so importing this module touches no process group.

:func:`init_distributed` brings up the default process group: from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) when it is there, else a one-rank group
on an in-process store.  The backend is NCCL on ``cuda`` (one card per
rank: the rank's ``LOCAL_RANK``) and gloo on ``cpu``; asking for ``cuda``
without a card raises, as ``core.runtime.resolve_device`` does.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.runtime import resolve_device

# 16 x 16 = 256 chips a pod; multi-pod: 2 pods = 512 chips
PRODUCTION_MESH = {False: ((16, 16), ("data", "model")),
                   True: ((2, 16, 16), ("pod", "data", "model"))}
DEBUG_MESH = ((2, 4), ("data", "model"))


def init_distributed(device="cuda") -> torch.device:
    """Brings up the default process group (if it is not up yet) and
    returns this rank's torch device."""
    dev = resolve_device(device, "device")
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def shutdown() -> None:
    """Tears the default process group down (if it is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _device_type() -> str:
    """The mesh's device: the host's on gloo, the card's on NCCL (and on a
    fake group, ``launch.dryrun``'s, whose tensors claim the card)."""
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's ranks
    (the default group must be up); raises unless the world has exactly
    ``prod(shape)`` ranks.  ``device_type`` defaults to the backend's."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)}"
                         " differ in length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world "
                         f"has {world}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16 x 16 = 256 ranks a pod; multi-pod: 2 pods = 512 ranks."""
    return make_mesh(*PRODUCTION_MESH[multi_pod], device_type=device_type)


def make_debug_mesh(shape=DEBUG_MESH[0], axes=DEBUG_MESH[1]):
    """A small mesh for tests (the world must have ``prod(shape)`` ranks)."""
    return make_mesh(shape, axes)
