"""device_idle_pct: the share of the traced window in which no kernel, copy
or fill ran on the device (1 - the union of their intervals over the
window)."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
