"""precas_roofline: the least time of the pre-CAS transform's work over the
device time of the kernels that precas_ms_per_frame.batch reads (neither a
copy nor in the CAS name table, cas_kernels/*.txt), in %.

The work is counted from the plan, whatever implements the layer (the
cuFFT form, the dense GEMMs, the staged circulant convolutions): per
channel of a frame, the conventional real-FFT count of 2.5 n log2 n
operations for the forward transform at n = h w plus the inverse at
n = H W; the uint8 input read once and the pre-CAS image written once at
the plan's storage width (Q2.14, 2 B, at -p 2; 4 B at -p 0; 8 B at -p 1).
The least time is the larger of the operations over the card's fp32 peak
and the bytes over its HBM bandwidth (peaks.py).  At -p 2 the operations
bind: the batch8 frames need 26-35 operations a byte moved, above the
H100's balance of 67 TFLOP/s over 3.35 TB/s, 20 a byte (the inverse alone
2.5 log2(H W), 57-62 operations, an output value of 2 B); at -p 0 and
-p 1 the bytes bind.
"""
import math
import os

import numpy as np

from vkbench.peaks import peaks_for
from vkbench.trace import is_copy, name_table

CAS = name_table(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cas_kernels"))
STORAGE_BYTES = {"HALF": 2, "SINGLE": 4, "DOUBLE": 8}


def _fft_ops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def work(config):
    """(bytes, fp32 operations) of one frame's pre-CAS transform."""
    u = np.float32(config["upscale"])
    h, w, c = config["h"], config["w"], config["channels"]
    H, W = int(np.float32(h) * u), int(np.float32(w) * u)
    nbytes = c * h * w + c * H * W * STORAGE_BYTES[config["precision"]]
    return nbytes, c * (_fft_ops(h * w) + _fft_ops(H * W))


def least_seconds(config, peaks):
    nbytes, ops = work(config)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops"])


def read(run):
    t, peaks = run.trace, peaks_for(run.card)
    if t is None or peaks is None or not run.frames:
        return None
    s = t.op_seconds(lambda n: not is_copy(n) and not any(k in n for k in CAS))
    if s <= 0:
        return None
    return 100.0 * run.frames * least_seconds(run.config, peaks) / s
