"""``panel_ms``: device milliseconds per call of the panel ops
(``panel_chol``, POTRF, and ``panel_trsm``, the panel's TRSM), from the
executor's spans."""

from oocbench.harness.ops import ops_where, spans_of

PANEL = ("panel_chol", "panel_trsm")


def read(run):
    total, n = 0.0, 0
    for e in run.execs:
        ops = ops_where(e, "COMPUTE", PANEL)
        s = spans_of(e, ops)
        if not ops or s is None:
            return None
        total += s
    calls = [c for c in run.calls if c.execs]
    return 1e3 * total / len(calls) if calls else None
