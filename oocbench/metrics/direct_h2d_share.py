"""``direct_h2d_share``: the share of the H2D bytes that the executor copied
straight from page-locked host operands, with no pinned staging: the
program's call records' ``direct_h2d_bytes`` over the H2D bytes of the
executor runs they record (``harness/steps.py`` joins the two), over the
window's last calls that the kept records cover.  None where the program
counts no such bytes."""

from oocbench.harness.steps import matched_steps


def read(run):
    steps = matched_steps(run, "direct_h2d_share", "attention")
    if steps is None:
        return None
    recs = [r for _, rs in steps for r in rs]
    if not all(hasattr(r, "direct_h2d_bytes") for r in recs):
        run.note("direct_h2d_share: the program's records count no direct "
                 "H2D bytes")
        return None
    moved = sum(e.h2d_bytes for c, _ in steps for e in c.execs)
    if not moved:
        return None
    return 100.0 * sum(r.direct_h2d_bytes for r in recs) / moved
