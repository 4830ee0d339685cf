"""``h2d_gbps``: bytes of the H2D ops over the summed device seconds of
their spans (the executor's CUDA events around each copy, without the host
staging fill), in GB/s (1e9)."""

from oocbench.harness.ops import ops_where, spans_of


def read(run):
    moved = secs = 0.0
    for e in run.execs:
        ops = ops_where(e, "H2D")
        s = spans_of(e, ops)
        if s is None:
            return None
        moved += sum(e.sched.ops[i].bytes for i in ops)
        secs += s
    return moved / secs / 1e9 if secs > 0 else None
