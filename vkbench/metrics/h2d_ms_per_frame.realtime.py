"""h2d_ms_per_frame: device time of host-to-device copies per frame: the
frame's upload from pinned host memory."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not run.frames:
        return None
    s = t.op_seconds(lambda n: n.startswith("Memcpy HtoD"))
    return 1e3 * s / run.frames if s > 0 else None
