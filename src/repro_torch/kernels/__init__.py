"""Hand-written Hopper kernels of the port (sources under ``csrc/``), each
beside its plain PyTorch version; see ``kernels/ops.py`` for the public
wrappers and ``kernels/ref.py`` for the test oracles."""

from __future__ import annotations

import threading
from typing import Optional

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, dtype: Optional[str] = None,
                 path: Optional[str] = None) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` and, given
    ``dtype``, ``wrapper.launches_by_dtype[dtype]`` (given ``path``,
    ``wrapper.launches_by_path[path]``) go up by one.  Under a lock, since
    several threads may launch at once (the hybrid members' executors) and
    a bare ``+= 1`` can lose an increment."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        for key, table in ((dtype, "launches_by_dtype"),
                           (path, "launches_by_path")):
            if key is not None:
                counts = getattr(wrapper, table)
                counts[key] = counts.get(key, 0) + 1
