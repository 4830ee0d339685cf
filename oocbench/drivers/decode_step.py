"""Driver of ``repro_torch.core.ooc_attention``, decode attention over a KV
cache in host RAM: one call is one decode step through every softmax layer.

The mix's ``Q`` is (layers, heads, head_dim) and ``K``/``V`` are (layers,
positions, kv_heads, head_dim).  A serving process keeps its cache
page-locked, so the first call that sees a ``K`` or ``V`` page-locks it in
place (``repro_torch.core.page_lock``) and the session keeps it locked
until it is dropped, or until a call brings another cache.  Each layer is
one ``ooc_attention`` call with the harness's executor, the
configuration's ``budget_bytes`` and ``options``; the layers' outputs are
stacked to (layers, heads, head_dim).
"""

import torch

from repro_torch.core import ooc_attention, page_lock


class Session:
    """The harness's executor and the page-locks of the cache in use."""

    def __init__(self, executor):
        self.executor = executor
        self.locks = {}     # storage address -> PageLock

    def lock(self, *caches):
        keys = [t.untyped_storage().data_ptr() for t in caches]
        if set(keys) != set(self.locks):
            for held in self.locks.values():
                held.release()
            self.locks = {k: page_lock(t) for k, t in zip(keys, caches)}


def prepare(config, executor):
    return Session(executor)


def call(session, operands, scalars, config):
    q, k, v = operands["Q"], operands["K"], operands["V"]
    session.lock(k, v)
    return torch.stack([
        ooc_attention(q[layer], k[layer], v[layer],
                      budget_bytes=int(config["budget_bytes"]),
                      executor=session.executor, **scalars,
                      **config.get("options", {}))
        for layer in range(q.shape[0])])
