"""``moved_gb``: host-device bytes per call, the executor's
``last_h2d_bytes + last_d2h_bytes``, in GB (1e9).  Each run's counters are
held to ``schedule_stats`` of the schedule it ran; a mismatch is printed."""

from repro_torch.core import schedule_stats


def read(run):
    calls = [c for c in run.calls if c.execs]
    if not calls:
        return None
    for e in run.execs:
        st = schedule_stats(e.sched)
        if (e.h2d_bytes, e.d2h_bytes) != (st["h2d_bytes"], st["d2h_bytes"]):
            run.note(f"moved_gb: executor H2D/D2H {e.h2d_bytes}/"
                     f"{e.d2h_bytes} B, schedule_stats {st['h2d_bytes']}/"
                     f"{st['d2h_bytes']} B")
    return sum(e.h2d_bytes + e.d2h_bytes for c in calls for e in c.execs) \
        / len(calls) / 1e9
