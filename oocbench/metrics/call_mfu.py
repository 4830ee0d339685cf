"""``call_mfu``: the calls' useful work over their summed walls (host clock
around each synchronised call), as a share of the card's data-sheet peak
in the configuration's dtype: the whole call's share of the peak."""


def read(run):
    peak = run.peak_flops()
    if not run.calls or peak is None:
        return None
    return 100.0 * sum(c.flops for c in run.calls) \
        / sum(c.wall_s for c in run.calls) / peak
