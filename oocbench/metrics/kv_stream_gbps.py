"""``kv_stream_gbps``: the bytes the window's steps stream host to device
(their executor runs' ``last_h2d_bytes``: the KV cache's blocks) over the
runs' walls (``last_wall_seconds``), in GB/s (1e9): the rate at which the
executor moves the cache, staging, waits and kernels included."""


def read(run):
    execs = run.execs
    wall = sum(e.wall_s for e in execs)
    if not execs or wall <= 0:
        return None
    return sum(e.h2d_bytes for e in execs) / wall / 1e9
