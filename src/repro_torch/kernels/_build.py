"""Build and load the port's hand-written CUDA kernels.

A kernel source ``csrc/<name>.cu`` exposes a plain C interface; it is
compiled with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/<name>-<hash>/lib<name>.so`` at the repository root (a
directory ``.gitignore`` lists) the first time a wrapper launches it, and
loaded with :mod:`ctypes`.  The directory name
carries a hash of the source and the flags, so an edited kernel is rebuilt
and a stale library is never loaded.  Delete ``build/repro_torch`` to force
a rebuild.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[Tuple[str, str], ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from csrc/ at first use")
    return found


def _library_path(name: str, csrc: pathlib.Path) -> pathlib.Path:
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def build(name: str, csrc: pathlib.Path = CSRC) -> dict:
    """Compile ``<csrc>/<name>.cu`` unless its library already exists.

    ``csrc`` defaults to the package's own sources; another directory
    builds that tree's kernel of the same name (to time two versions side
    by side).  Returns ``{"path", "seconds", "ptxas", "cached"}``;
    ``ptxas`` is the compiler's output (register and spill counts).  Raises
    with that output if ``nvcc`` fails."""
    csrc = pathlib.Path(csrc)
    so = _library_path(name, csrc)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "ptxas": "", "cached": True}
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):"
                           f"\n{proc.stdout}")
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "ptxas": proc.stdout, "cached": False}


def load(name: str, csrc: pathlib.Path = CSRC) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (from ``csrc``), built first if
    needed."""
    key = (name, str(pathlib.Path(csrc).resolve()))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(name, csrc)["path"])
            _loaded[key] = lib
        return lib
