"""The traced run's reading of torch.profiler's events (CPU and CUDA
activities), the benchmark's own spans included: "vkbench.window" around
the window and "vkbench.call" around each call's dispatch.

Device operations are the CUDA activities that are not annotations:
kernels, and copies and fills (their names start with "Memcpy" and
"Memset").  Each is tied to the host call that launched it by its CUPTI
correlation id (the CUDA API call, cuda* or cu*, carries the same id),
and so to the benchmark's call span that the launch fell in.
"""
from __future__ import annotations

import bisect
import os
from collections import defaultdict

WINDOW, CALL = "vkbench.window", "vkbench.call"
SHORT_GAP_NS = 2000  # idle gaps below this are launch latency, summed apart


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without "void ", "(anonymous namespace)::" and its
    argument list, at most `width` characters."""
    if name.startswith("void "):
        name = name[5:].replace("(anonymous namespace)::", "")
        depth = 0
        for i, ch in enumerate(name):
            depth += 1 if ch in "<(" else -1 if ch in ">)" else 0
            if ch == "(" and depth == 1:
                name = name[:i]
                break
    return name if len(name) <= width else name[:width - 3] + "..."


def name_table(directory: str) -> list:
    """The kernel-name substrings of every *.txt in `directory`, one a
    line, "#" starting a comment."""
    names = []
    for f in sorted(os.listdir(directory)):
        if f.endswith(".txt"):
            with open(os.path.join(directory, f)) as fh:
                names += [ln.split("#")[0].strip() for ln in fh]
    return [n for n in names if n]


class Trace:
    """ops: (name, start_ns, end_ns, launched in a call span) per device
    operation inside the window; window_ns: (start, end) of the window."""

    def __init__(self, events):
        ops, host, launches, calls, window = [], [], {}, [], None
        for e in events:
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation():
                    ops.append((name, start, end, e.correlation_id()))
                continue
            if e.is_user_annotation():
                if name == WINDOW:
                    window = (start, end)
                    continue
                if name == CALL:
                    calls.append((start, end))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = start
            host.append((start, end, name))
        if window is None:
            raise ValueError("the trace holds no vkbench.window span")
        calls.sort()
        starts = [c[0] for c in calls]

        def in_call(t):
            k = bisect.bisect_right(starts, t) - 1
            return k >= 0 and t <= calls[k][1]

        w0, w1 = window
        self.window_ns = window
        self.ops = [(n, max(s, w0), min(t, w1), c in launches and in_call(launches[c]))
                    for n, s, t, c in ops if t > w0 and s < w1]
        self.ops.sort(key=lambda o: o[1])
        host.sort()
        self._host = host

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, in time order."""
        out = []
        for _, s, t, _ in self.ops:
            if out and s <= out[-1][1]:
                if t > out[-1][1]:
                    out[-1][1] = t
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def op_seconds(self, keep=lambda name: True) -> float:
        return sum(t - s for n, s, t, _ in self.ops if keep(n)) / 1e9

    def ops_in_calls(self) -> int:
        """Device operations launched inside a call span."""
        return sum(1 for o in self.ops if o[3])

    def top_ops(self, k: int = 10):
        """[[name, seconds], ...]: the k device operations that took most."""
        by = defaultdict(int)
        for n, s, t, _ in self.ops:
            by[n] += t - s
        return [[short_name(n), v / 1e9]
                for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """[[host activity, seconds], ...]: the device's idle time in the
        window, grouped by the innermost host span (operator, runtime call
        or the benchmark's span) that was open when each gap began; gaps
        under 2 us are summed as launch latency."""
        busy = self.busy_intervals()
        w0, w1 = self.window_ns
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        starts = [h[0] for h in self._host]
        by = defaultdict(int)
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            if g1 - g0 < SHORT_GAP_NS:
                by["gaps under 2 us (launch latency)"] += g1 - g0
                continue
            label = "host outside any traced span"
            j = bisect.bisect_right(starts, g0) - 1
            for h in range(j, max(-1, j - 1024), -1):
                if self._host[h][1] >= g0:
                    label = self._host[h][2]
                    break
            by[label] += g1 - g0
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
