"""``tflops``: useful work of every call completed in the window, over the
window, from its start to the end of its last call (host clock)."""


def read(run):
    if not run.calls:
        return None
    return sum(c.flops for c in run.calls) / run.window_s / 1e12
