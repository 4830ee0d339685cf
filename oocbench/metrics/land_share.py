"""``land_share``: the host's time landing write-backs (``executor.land``:
the wait for each D2H copy's event and the store of its pinned staging into
the host output) as a share of the executor runs' walls, summed over the
window; the counterpart of ``staging_share``."""

from oocbench.harness.calls import matched


def read(run):
    recs = matched(run, "land_share")
    if recs is None:
        return None
    wall = sum(sum(r.exec_walls) for r in recs)
    if not wall:
        return None
    return 100.0 * sum(r.seconds.get("executor.land", 0.0)
                       for r in recs) / wall
