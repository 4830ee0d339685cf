"""``plan_ms``: per call, the milliseconds of the entry point's planning
span (the partition or factor spec, the schedule's build or compilation,
the panel ops' workspace query), from the program's call records."""

from oocbench.harness.calls import matched, own_seconds


def read(run):
    recs = matched(run, "plan_ms")
    if recs is None:
        return None
    return 1e3 * sum(own_seconds(r, (".plan",)) for r in recs) / len(recs)
