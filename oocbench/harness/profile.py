"""The device's side of a traced window, read from ``torch.profiler``'s raw
events (its own aggregation is slow on many events).

The window is the span of the harness's ``WINDOW`` annotation.  Busy time
is the union of the device's kernels, copies and fills, clipped to it; an
idle gap is a stretch between them, named by the host operations that
overlap it most.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from oocbench.harness.record import Profile

PREFIX = "oocbench."
WINDOW = PREFIX + "window"
TOP = 10


def _merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _host_label(a: int, b: int, host) -> str:
    """The host operations that overlap the gap ``[a, b)`` most, by name
    (a nested operation counts beside its parent), those of at least a
    tenth of it, at most three; the harness's own annotations only where
    no operation of the program's overlaps that much."""
    own, prog = {}, {}
    for name, s, e in host:
        ov = min(b, e) - max(a, s)
        if ov > 0:
            into = own if name.startswith(PREFIX) else prog
            into[name] = into.get(name, 0) + ov
    for by in (prog, own):
        top = [n for n, ov in sorted(by.items(), key=lambda kv: -kv[1])
               if ov >= 0.1 * (b - a)][:3]
        if top:
            return " + ".join(top)
    return "host"


def read(prof) -> Optional[Profile]:
    """The traced window's busy seconds, its device operations by total
    time and its longest idle gaps; None without the window's annotation."""
    from torch.autograd import DeviceType

    window = None
    host: List[Tuple[str, int, int]] = []
    device: List[Tuple[str, int, int]] = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        span = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                window = span
            else:
                host.append(span)
        elif not e.is_user_annotation() and not e.name().endswith("Sync"):
            # kernels, copies and fills; not the annotations' device-side
            # ranges nor the waits that CUDA sync records span
            device.append(span)
    if window is None:
        return None
    w0, w1 = window[1], window[2]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    busy = _merged([(s, e) for _, s, e in inside])
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:TOP]
    return Profile(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        device_ops=[[n, ns / 1e9] for n, ns in ops],
        idle_gaps=[[_host_label(a, b, host), (b - a) / 1e9]
                   for a, b in gaps])
