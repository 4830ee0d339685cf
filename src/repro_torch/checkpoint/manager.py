"""Atomic, async checkpointing of a train state.

Port of ``src/repro/checkpoint/manager.py``, with its contract:

  * **Atomic**: the state is written to ``<dir>/tmp.<step>.<process>`` and
    renamed to ``<dir>/step_<step>`` only after the manifest is fsynced, so
    a crash mid-save never corrupts the latest valid checkpoint.
  * **Async**: ``save()`` copies every tensor to host memory before it
    returns (the train step updates the state in place right after) and
    hands the file I/O to a background thread; call ``wait()`` before
    reading the directory or at exit.
  * ``keep`` newest checkpoints survive; older ones are removed after each
    save.

A state is a nested dict of tensors (the train state of
``training/steps.py``); each leaf is named by its path of keys joined by
``.`` (``params.layers.0.attn.wq``, ``opt.count``).  The manifest holds
``step``, ``data_cursor`` and, per leaf, its ``file``, ``shape`` and
``dtype``.  Leaves are ``.npy`` files; a bfloat16 leaf, which numpy has no
type for, is stored as its ``uint16`` bits with ``"bfloat16"`` in the
manifest.  ``restore`` writes into the tensors of a target state of the
same structure, on their device.

Sharded states: a DTensor leaf is gathered (``full_tensor()``, which every
rank calls) and rank 0 alone writes the checkpoint; every rank then waits
on a barrier, at the save when it blocks and else at the next ``wait()``.
On restore each rank reads the full leaves and keeps its shard of each:
into a DTensor target as it is placed, or, with ``shardings=`` (a tree of
placements from ``distributed.tree_shardings``) and ``mesh=``, onto new
DTensors (``distribute_tensor``), as the reference re-shards a checkpoint
onto the current mesh.  A checkpoint written on one mesh restores onto
another (``tests/test_torch_elastic*.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: str = "", is_leaf=lambda x: False
            ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping) and not is_leaf(v):
            yield from _leaves(v, name + ".", is_leaf)
        else:
            yield name, v


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, and the dtype the manifest names."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _shard_of(full: torch.Tensor, mesh, placements):
    """``full`` as a DTensor of which this rank keeps its own shard (every
    rank holds the same full tensor, so nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, mesh, placements, src_data_rank=None)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        self._thread: Optional[threading.Thread] = None
        self._barrier = False       # a sharded save the ranks still await
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Mapping, data_cursor: int = 0,
             blocking: bool = False) -> None:
        self.wait()
        leaves = list(_leaves(state))
        sharded = any(_is_dtensor(t) for _, t in leaves)
        if sharded:   # every rank gathers; rank 0 alone writes
            leaves = [(n, t.full_tensor() if _is_dtensor(t) else t)
                      for n, t in leaves]
            self._barrier = True
            if _rank() != 0:
                if blocking:
                    self.wait()
                return
        # snapshot to host synchronously, then write async
        host = [(name, *_to_numpy(leaf)) for name, leaf in leaves]

        def _write():
            tmp = os.path.join(self.dir, f"tmp.{step}.{self.proc}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "data_cursor": data_cursor,
                        "leaves": {}}
            for i, (name, arr, dtype) in enumerate(host):
                fn = f"{i:08x}.{self.proc}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"][name] = {
                    "file": fn, "shape": list(arr.shape), "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Mapping, shardings=None,
                mesh=None) -> Tuple[Dict, int]:
        """Loads checkpoint ``step``.  Without ``shardings``, into
        ``target``, a state of the same structure: each tensor of
        ``target`` is overwritten in place (on its device, in its dtype; a
        DTensor with its own shard), so a model whose parameters the state
        names trains on from the restored values.  With ``shardings`` (a
        tree of DTensor placements of ``target``'s structure) and ``mesh``,
        ``target``'s leaves give only shapes (tensors of any device,
        ``meta`` included) and each loaded leaf is placed onto ``mesh`` as a
        new DTensor, in the target leaf's dtype.  Raises ``ValueError``
        when a leaf's shape differs.  Returns (state, data_cursor)."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = [(name, tgt, manifest["leaves"][name])
                  for name, tgt in _leaves(target)]
        for name, tgt, meta in leaves:               # all before any write
            if tuple(meta["shape"]) != tuple(tgt.shape):
                raise ValueError(f"checkpoint leaf {name} shape "
                                 f"{tuple(meta['shape'])} != "
                                 f"{tuple(tgt.shape)}")
        if shardings is not None and mesh is None:
            raise ValueError("shardings= needs the mesh= they place onto")
        places = dict(_leaves(shardings, is_leaf=lambda x: isinstance(
            x, tuple))) if shardings is not None else {}
        out: Dict = {}
        with torch.no_grad():
            for name, tgt, meta in leaves:
                full = _from_numpy(np.load(os.path.join(path, meta["file"])),
                                   meta["dtype"])
                if shardings is not None:
                    out[name] = _shard_of(
                        full.to(device=mesh.device_type, dtype=tgt.dtype),
                        mesh, places[name])
                elif _is_dtensor(tgt):
                    local = tgt.to_local()
                    local.copy_(_shard_of(full.to(local.device),
                                          tgt.device_mesh,
                                          tgt.placements).to_local())
                else:
                    tgt.copy_(full)
        if shardings is None:
            return target, manifest["data_cursor"]
        return _rebuild(target, out), manifest["data_cursor"]


def _rebuild(tree: Mapping, by_name: Dict, prefix: str = "") -> Dict:
    """``tree``'s structure with the leaf at each path from ``by_name``."""
    return {k: _rebuild(v, by_name, f"{prefix}{k}.")
            if isinstance(v, Mapping) else by_name[f"{prefix}{k}"]
            for k, v in tree.items()}
