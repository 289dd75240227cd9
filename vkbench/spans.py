"""The port's own spans in a traced run: "vkr.call" around each call of a
built pipeline (vkresample_tpu_torch/utils/profiling.py, which opens it
only while a profiler runs), read from the trace's host events on the
profiler's clock beside the device operations (trace.Trace).

A program without the span (an older commit) leaves the list of calls
empty, and the port_* readers then read nothing, not zero.
"""
from __future__ import annotations

PORT_CALL = "vkr.call"


def port_calls(trace) -> list:
    """[(start_ns, end_ns)] of every vkr.call span that overlaps the
    window, clipped to it, in time order."""
    w0, w1 = trace.window_ns
    return sorted((max(s, w0), min(t, w1)) for s, t, name in trace._host
                  if name == PORT_CALL and t > w0 and s < w1)


def union(spans) -> list:
    """The union of time-ordered (start, end) intervals, as disjoint
    [start, end] lists."""
    out = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def overlap_ns(a, b) -> int:
    """The time two unions of disjoint, time-ordered intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_calls_ns(trace) -> int:
    """Time inside the window when a vkr.call span is open and no device
    operation runs: the device waiting on the port's own dispatch."""
    calls = union(port_calls(trace))
    return sum(t - s for s, t in calls) - overlap_ns(calls, trace.busy_intervals())
