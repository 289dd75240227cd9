"""cas_roofline: the least time of the CAS stage's work over the device
time of the kernels that do it, in %.

The work is counted from the plan, whatever kernel does it: per output
value (channels x H x W of a frame) the pre-CAS image read once at the
plan's storage width (Q2.14, 2 B, at -p 2; 4 B at -p 0; 8 B at -p 1) and
the uint8 output written once; about 40 fp32 operations.  The least time
is the larger of the bytes over the card's HBM bandwidth and the
operations over its fp32 peak (peaks.py).  The kernels are those whose
names hold an entry of cas_kernels/*.txt; a plan whose CAS runs in none of
them (-p 1) reads nothing.
"""
import os

import numpy as np

from vkbench.peaks import peaks_for
from vkbench.trace import name_table

CAS = name_table(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cas_kernels"))
STORAGE_BYTES = {"HALF": 2, "SINGLE": 4, "DOUBLE": 8}
OPS_PER_VALUE = 40


def work(config):
    """(bytes, fp32 operations) of one frame's CAS stage."""
    u = np.float32(config["upscale"])
    H, W = int(np.float32(config["h"]) * u), int(np.float32(config["w"]) * u)
    values = config["channels"] * H * W
    return values * (STORAGE_BYTES[config["precision"]] + 1), values * OPS_PER_VALUE


def least_seconds(config, peaks):
    nbytes, ops = work(config)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops"])


def read(run):
    t, peaks = run.trace, peaks_for(run.card)
    if t is None or peaks is None or not run.frames:
        return None
    s = t.op_seconds(lambda n: any(k in n for k in CAS))
    if s <= 0:
        return None
    return 100.0 * run.frames * least_seconds(run.config, peaks) / s
