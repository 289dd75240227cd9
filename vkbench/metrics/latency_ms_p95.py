"""latency_ms_p95: the 95th percentile (numpy's linear rule) of every call's
span in the window, submission to completion, from CUDA events
(loadgen.py's docstring).  A call is a user's frame where the traffic sends
one frame a call."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms, 95)) if run.latencies_ms else None
