"""precas_ms_per_frame: device time per frame of every kernel that is
neither a copy nor of the CAS stage (the names in cas_kernels/*.txt): the
pre-CAS transform, its spectrum shift, the Q2.14 staging and the casts."""
import os

from vkbench.trace import is_copy, name_table

CAS = name_table(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cas_kernels"))


def read(run):
    t = run.trace
    if t is None or not t.ops or not run.frames:
        return None
    s = t.op_seconds(lambda n: not is_copy(n) and not any(k in n for k in CAS))
    return 1e3 * s / run.frames
