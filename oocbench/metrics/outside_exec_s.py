"""``outside_exec_s``: per call, the call's wall less its executor runs'
``last_wall_seconds`` (planning, operand intake, C's zero-fill and clone,
result assembly), averaged over the window's calls."""


def read(run):
    calls = [c for c in run.calls if c.execs]
    if not calls:
        return None
    return sum(c.wall_s - sum(e.wall_s for e in c.execs)
               for c in calls) / len(calls)
