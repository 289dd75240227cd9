"""launches_per_frame: device operations (kernels, copies, fills) launched
inside the benchmark's call spans, per frame: the host's dispatch count,
upload included.  A count: it repeats exactly while the route does."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not run.frames:
        return None
    return t.ops_in_calls() / run.frames
