"""``device_idle``: the share of the traced window in which neither a
kernel nor a copy ran on the card (``torch.profiler``)."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
