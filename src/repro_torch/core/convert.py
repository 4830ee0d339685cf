"""State carried across from the reference package.

This system has no weights: its state is the partition, the schedule and
the operands.  :func:`from_reference` turns a reference object —
``GemmPartition``, ``AttentionPartition``, ``Device``, ``Schedule`` (ops,
events, ``SliceRef``/``BlockRef`` payloads, ``reuse``, ``meta``), ``Op``,
``Event``, payloads, a simulator ``HardwareModel``, or an array operand —
into the port's equivalent, so a test can run the reference's own schedule
through the port's executor.  It reads attributes only, dispatching on the
class name, and imports nothing of the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partitioner import AttentionPartition, GemmPartition
from repro_torch.core.runtime import as_tensor
from repro_torch.core.simulator import HardwareModel
from repro_torch.core.streams import (BlockRef, Device, Event, Op, OpKind,
                                      Schedule, SliceRef, StreamFactory)


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def _event(ev):
    return None if ev is None else Event(ev.name)


def _payload(p):
    if p is None:
        return None
    return from_reference(p)


def _op(op) -> Op:
    return Op(kind=OpKind[op.kind.name], tag=op.tag, stream=op.stream,
              waits=tuple(_event(e) for e in op.waits),
              records=_event(op.records),
              buffers_read=tuple(op.buffers_read),
              buffers_written=tuple(op.buffers_written),
              bytes=op.bytes, flops=op.flops, payload=_payload(op.payload))


def _schedule(sched) -> Schedule:
    dev = from_reference(sched.device)
    out = Schedule(dev, StreamFactory.create(dev, len(sched.streams)),
                   reuse={k: dict(v) for k, v in sched.reuse.items()},
                   meta=dict(sched.meta))
    for op in sched.ops:
        out.issue(_op(op))
    return out


def _array(x) -> torch.Tensor:
    return as_tensor(np.array(x))   # a writable host copy, whatever the type


_CONVERTERS = {
    "GemmPartition": lambda o: GemmPartition(**_fields(GemmPartition, o)),
    "AttentionPartition":
        lambda o: AttentionPartition(**_fields(AttentionPartition, o)),
    "Device": lambda o: Device(o.name, o.id, o.mem_bytes),
    "SliceRef": lambda o: SliceRef(**_fields(SliceRef, o)),
    "BlockRef": lambda o: BlockRef(o.kernel, o.index),
    "Event": _event,
    "Op": _op,
    "Schedule": _schedule,
    "HardwareModel": lambda o: HardwareModel(**{
        **_fields(HardwareModel, o),
        "pools": dict(o.pools),
        "kind_pool": {OpKind[k.name]: v for k, v in o.kind_pool.items()}}),
}


def from_reference(obj):
    """The port's equivalent of a reference object (see module doc)."""
    conv = _CONVERTERS.get(type(obj).__name__)
    if conv is not None:
        return conv(obj)
    if hasattr(obj, "__array__") and not isinstance(obj, torch.Tensor):
        return _array(obj)
    raise TypeError(f"no port equivalent for {type(obj).__name__}")
