"""port_idle_pct: the share of the traced window in which a vkr.call span
(the port's call, vkbench/spans.py) is open and no kernel, copy or fill
runs: the part of device_idle_pct that waits on the port's own host
dispatch; the rest waits on the upload's launch and the loop.  None where
the program opens no such span."""
from vkbench.spans import idle_in_calls_ns, port_calls


def read(run):
    t = run.trace
    if t is None or not port_calls(t):
        return None
    return 100.0 * idle_in_calls_ns(t) / 1e9 / t.window_s
