"""``entry_host_s``: per call, the seconds of the entry point's own spans
(``<entry>.*``) other than its executor run's (``<entry>.execute``):
intake, planning, C's zero-fill and clone or A's clone and the ``tril``,
drift; from the program's call records, averaged over the window's
calls."""

from oocbench.harness.calls import matched, own_seconds


def read(run):
    recs = matched(run, "entry_host_s")
    if recs is None:
        return None
    return sum(own_seconds(r) - own_seconds(r, (".execute",))
               for r in recs) / len(recs)
