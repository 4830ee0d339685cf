"""``staging_share``: the host's time filling pinned H2D staging from the
host operands (``last_stage_seconds``) as a share of the executor runs'
walls (``last_wall_seconds``), summed over the window."""


def read(run):
    wall = sum(e.wall_s for e in run.execs)
    if not wall:
        return None
    return 100.0 * sum(e.stage_s for e in run.execs) / wall
