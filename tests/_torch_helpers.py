"""Helpers shared by the port's tests: a fixture and a hand-built schedule
written against either package (``mod`` is ``repro.core`` or
``repro_torch.core``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch CPU work on one intra-op thread.  The suite
    runs six workers on eight cores, so more threads only contend; and the
    CPU plain path's bit-for-bit checks need a BLAS that sums each element
    over K in one order, which multi-threaded MKL does not promise (it may
    split K across threads depending on the shape).  On the card the
    hand-written kernel fixes the order by construction."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def overlap_schedule(mod):
    """Two steps whose C row blocks overlap (rows 0:4, then 2:6).  The event
    program does not order the second step's H2D of C after the first
    step's D2H: only the host-coherence rule makes it read the landed
    rows."""
    dev = mod.Device("HBM", 0, 1 << 20)
    sched = mod.Schedule(dev, mod.StreamFactory.create(dev, 2))
    ev = mod.Event
    for s, r0 in ((0, 0), (1, 2)):
        rows = (r0, 4)
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag=f"S(a[{s}])", stream=s,
                           records=ev(f"rA{s}"), buffers_written=(("A", s),),
                           bytes=4 * 8 * 4,
                           payload=mod.SliceRef("A", s, rows=rows)))
        if s == 0:
            sched.issue(mod.Op(kind=mod.OpKind.H2D, tag="S(b[0])", stream=0,
                               records=ev("rB0"),
                               buffers_written=(("B", 0),), bytes=8 * 6 * 4,
                               payload=mod.SliceRef("B", 0)))
        sched.issue(mod.Op(kind=mod.OpKind.H2D, tag=f"S(c[{s}])", stream=s,
                           records=ev(f"rC{s}"), buffers_written=(("C", s),),
                           bytes=4 * 6 * 4,
                           payload=mod.SliceRef("C", s, rows=rows)))
        sched.issue(mod.Op(kind=mod.OpKind.COMPUTE, tag=f"DGEMM[{s}]",
                           stream=s,
                           waits=(ev(f"rA{s}"), ev("rB0"), ev(f"rC{s}")),
                           records=ev(f"eA{s}"),
                           buffers_read=(("A", s), ("B", 0)),
                           buffers_written=(("C", s),), flops=2 * 4 * 6 * 8,
                           payload=mod.BlockRef("dgemm", s)))
        sched.issue(mod.Op(kind=mod.OpKind.D2H, tag=f"R(c[{s}])", stream=s,
                           waits=(ev(f"eA{s}"),), records=ev(f"wC{s}"),
                           buffers_read=(("C", s),), bytes=4 * 6 * 4,
                           payload=mod.SliceRef("C", s, rows=rows)))
    return sched
