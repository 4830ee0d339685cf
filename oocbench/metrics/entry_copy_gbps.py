"""``entry_copy_gbps``: the bytes that the entry point's own host copies
wrote (C's zero-fill and clone; A's clone and the ``tril``) over the
seconds of their spans, summed over the window's calls, in GB/s (1e9)."""

from oocbench.harness.calls import matched, own_seconds

COPIES = (".zero_c", ".clone_c", ".clone_a", ".tril")


def read(run):
    recs = matched(run, "entry_copy_gbps")
    if recs is None:
        return None
    secs = sum(own_seconds(r, COPIES) for r in recs)
    moved = sum(r.copy_bytes for r in recs)
    return moved / secs / 1e9 if secs > 0 and moved else None
