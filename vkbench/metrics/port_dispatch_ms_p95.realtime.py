"""port_dispatch_ms_p95: the 95th percentile (numpy's linear rule) of the
vkr.call spans' durations in the traced window (vkbench/spans.py), one span
a call: the host time the port takes to dispatch a frame.  None where the
program opens no such span."""
import numpy as np

from vkbench.spans import port_calls


def read(run):
    t = run.trace
    calls = port_calls(t) if t is not None else []
    if not calls:
        return None
    return float(np.percentile([(e - s) / 1e6 for s, e in calls], 95))
