"""``attn_host_ms``: per ``ooc_attention`` call (one layer of a step), the
host milliseconds of the entry point's own spans other than its executor
run's (``attention.intake``, ``attention.plan``, ``attention.out``), from
the program's call records of the window's last calls that the kept
records cover."""

from oocbench.harness.calls import own_seconds
from oocbench.harness.steps import matched_steps


def read(run):
    steps = matched_steps(run, "attn_host_ms", "attention")
    if steps is None:
        return None
    recs = [r for _, rs in steps for r in rs]
    return 1e3 * sum(own_seconds(r) - own_seconds(r, (".execute",))
                     for r in recs) / len(recs)
