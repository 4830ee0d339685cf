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
same structure, on their device.  Re-sharding on restore (the reference's
``shardings=``) waits for ROADMAP module item 13.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, and the dtype the manifest names."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


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
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Mapping, data_cursor: int = 0,
             blocking: bool = False) -> None:
        self.wait()
        # snapshot to host synchronously, then write async
        host = [(name, *_to_numpy(leaf)) for name, leaf in _leaves(state)]

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
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int, target: Mapping) -> Tuple[Dict, int]:
        """Loads checkpoint ``step`` into ``target``, a state of the same
        structure: each tensor of ``target`` is overwritten in place (on
        its device, in its dtype), so a model whose parameters the state
        names trains on from the restored values.  Raises ``ValueError``
        when a leaf's shape differs.  Returns (target, data_cursor)."""
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
        with torch.no_grad():
            for _, tgt, meta in leaves:
                arr = np.load(os.path.join(path, meta["file"]))
                tgt.copy_(_from_numpy(arr, meta["dtype"]))
        return target, manifest["data_cursor"]
