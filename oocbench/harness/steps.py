"""The program's records of a window whose calls each make several
entry-point calls: a decode step makes one ``ooc_attention`` call a layer.

``harness/calls.py`` joins one record to each call of the window.  Here
each executor run of a window's call comes from a record of its own, and
the program keeps its last few hundred records, fewer than a long window
of such calls makes: the last records are dealt, in order, to the calls at
the window's end that they cover whole, and each call's records' executor
walls, one after another, are held to the harness's own copy of its runs'
walls (the same floats, so the join is exact).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def matched_steps(run, metric: str, entry: str
                  ) -> Optional[List[Tuple[object, list]]]:
    """``(call, records)`` for the window's last calls that the program's
    kept records of ``entry`` (the program's entry point, such as
    ``attention``) cover whole, in order; None (with a note) where the
    program keeps none, or they do not match the calls' runs."""
    from repro_torch.obs import get_observability

    kept = getattr(get_observability(), "calls", None)
    if kept is None:
        run.note(f"{metric}: the program keeps no call records")
        return None
    done = [r for r in kept if r.entry == entry and r.ok]
    calls, need = [], 0
    for c in reversed(run.calls):
        if not c.execs or need + len(c.execs) > len(done):
            break
        calls.insert(0, c)
        need += len(c.execs)
    if not calls:
        run.note(f"{metric}: {len(done)} completed {entry} records cover "
                 f"no call of the window")
        return None
    recs = done[len(done) - need:]
    steps, i = [], 0
    for c in calls:
        mine = recs[i:i + len(c.execs)]
        i += len(c.execs)
        walls = [w for r in mine for w in r.exec_walls]
        if walls != [e.wall_s for e in c.execs]:
            run.note(f"{metric}: a call's executor walls "
                     f"{[e.wall_s for e in c.execs]} differ from its "
                     f"records' {walls}")
            return None
        steps.append((c, mine))
    return steps
