"""port_dispatch_pct: the share of the traced window that the host spends
inside the port's calls (the union of the vkr.call spans, vkbench/spans.py):
how near the host is to pacing the device, which it does at 100 %.  None
where the program opens no such span."""
from vkbench.spans import port_calls, union


def read(run):
    t = run.trace
    if t is None or not port_calls(t):
        return None
    return 100.0 * sum(e - s for s, e in union(port_calls(t))) / 1e9 / t.window_s
