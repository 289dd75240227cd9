"""Map the JAX package's DFT bank dict onto the port's.

The JAX u=2 banks (vkresample_tpu/fft/dense.py::r2c_rows_banks) carry the
odd-column x bank as a bf16 hi|lo split for the TPU's MXU; the port runs
one float32 GEMM, so ``alpha_odd = alpha_odd_hi + alpha_odd_lo`` (exact in
float32).  ``Ymat_ns``, ``Y1n`` and ``beta`` carry over as they are.  The
tests use this to feed both implementations the very same banks.
"""
from __future__ import annotations

import numpy as np
import torch


def banks_from_jax(banks: dict, device=None) -> dict:
    """JAX bank dict (numpy arrays) -> the port's float32 device banks."""
    hi = np.asarray(banks["alpha_odd_hi"]).astype(np.float32)
    lo = np.asarray(banks["alpha_odd_lo"]).astype(np.float32)
    out = {"alpha_odd": hi + lo}
    for key in ("Ymat_ns", "Y1n", "beta"):
        if key in banks:
            out[key] = np.asarray(banks[key]).astype(np.float32)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in out.items()
    }
