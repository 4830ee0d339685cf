"""Deterministic, seekable, host-sharded data pipeline.

Copy of ``src/repro/data/pipeline.py`` (numpy only; the port imports
nothing of the reference package): the same sources give bitwise the same
batches.  The trainer moves them to the card itself (``launch/train.py``).

Fault-tolerance contract: ``batch_at(step)`` is a pure
function of (seed, step, host shard), so a restarted/rescaled job resumes
from the checkpointed step with byte-identical data — no sample loss, no
duplicate visits, and straggler re-assignment is just re-indexing.

Two sources:
  * SyntheticSource — counter-based tokens (splitmix-style hash); used by
    examples/tests and the dry-run.
  * MemmapSource — token stream from a binary .npy/.bin file, windowed.

A background prefetch thread keeps ``depth`` batches ready (host-side
overlap of data and compute — the paper's H2D stage at the training level).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class SyntheticSource:
    """Deterministic token batches: token[b, s] = hash(seed, step, b, s)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch_at(self, step: int, batch: int, seq: int,
                 host_index: int = 0, host_count: int = 1) -> Dict:
        assert batch % host_count == 0
        local = batch // host_count
        b0 = host_index * local
        idx = (np.uint64(self.seed) << np.uint64(40)) \
            + (np.uint64(step) << np.uint64(20))
        rows = np.arange(b0, b0 + local, dtype=np.uint64)[:, None]
        cols = np.arange(seq + 1, dtype=np.uint64)[None, :]
        h = _splitmix64(idx + rows * np.uint64(100003) + cols)
        toks = (h % np.uint64(self.vocab)).astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapSource:
    """Token stream in a flat int32 file; step/host -> deterministic window."""

    def __init__(self, path: str, vocab_size: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab = vocab_size

    def batch_at(self, step: int, batch: int, seq: int,
                 host_index: int = 0, host_count: int = 1) -> Dict:
        assert batch % host_count == 0
        local = batch // host_count
        n = len(self.tokens)
        span = seq + 1
        stride = max(1, (n - span) // max(1, batch))
        b0 = host_index * local
        rows = []
        for b in range(b0, b0 + local):
            start = ((step * batch + b) * stride) % (n - span)
            rows.append(np.asarray(self.tokens[start:start + span]))
        toks = np.stack(rows) % self.vocab
        return {"inputs": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background thread keeping ``depth`` upcoming batches materialized."""

    def __init__(self, source, batch: int, seq: int, start_step: int = 0,
                 depth: int = 2, host_index: int = 0, host_count: int = 1):
        self.source = source
        self.args = (batch, seq, host_index, host_count)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _fill(self):
        step = self.step
        batch, seq, hi, hc = self.args
        while not self._stop.is_set():
            b = self.source.batch_at(step, batch, seq, hi, hc)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2.0)
