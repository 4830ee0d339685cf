"""The program's own records of the window's calls.

``repro_torch.obs`` keeps a record of each entry-point call made with an
executor that records spans (the traced run's): host seconds by span name,
the bytes the entry point's own host copies wrote, and the walls of its
executor runs.  A reader takes the last records of the cell's entry point,
one for each call of the window, and holds each record's executor walls to
the harness's own copy of them (the same floats, so the join is exact).
"""

from __future__ import annotations

from typing import List, Optional


def matched(run, metric: str) -> Optional[List]:
    """The program's records of ``run``'s calls, in order; None (with a
    note) where the program keeps none, or they do not match the calls."""
    from repro_torch.obs import get_observability

    kept = getattr(get_observability(), "calls", None)
    if kept is None:
        run.note(f"{metric}: the program keeps no call records")
        return None
    entry = run.config["entry"]
    done = [r for r in kept if r.entry == entry and r.ok]
    n = len(run.calls)
    if not n or len(done) < n:
        run.note(f"{metric}: {len(done)} completed {entry} records for "
                 f"{n} calls")
        return None
    recs = done[-n:]
    for i, (r, c) in enumerate(zip(recs, run.calls)):
        if list(r.exec_walls) != [e.wall_s for e in c.execs]:
            run.note(f"{metric}: call {i}'s executor walls "
                     f"{[e.wall_s for e in c.execs]} differ from its "
                     f"record's {list(r.exec_walls)}")
            return None
    return recs


def own_seconds(rec, names=None) -> float:
    """The record's seconds under the entry point's own spans
    (``<entry>.*``), or under those whose names end in one of ``names``
    (``.plan``, ...)."""
    head = rec.entry + "."
    return sum(s for k, s in rec.seconds.items()
               if k.startswith(head)
               and (names is None or k.endswith(tuple(names))))
