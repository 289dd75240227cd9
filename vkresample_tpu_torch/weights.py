"""Map the JAX package's DFT bank dicts onto the port's.

The JAX row-split banks (vkresample_tpu/fft/dense.py::r2c_rows_banks, every
integer u >= 2) carry the x banks as a bf16 hi|lo split for the TPU's MXU;
the port runs one float32 GEMM, so ``alpha = alpha_hi + alpha_lo`` and, at
u=2, ``alpha_odd = alpha_odd_hi + alpha_odd_lo`` (exact in float32).
``Ymat_ns``, ``Y1n`` and ``beta`` carry over as they are, and so do the
chain banks (r2c_chain_banks: ``alpha``, ``Ymat``, ``Y1``, ``beta``).  The
fused y-GEMM + CAS bank ``ycasYT`` (u=2, built under
``VKRESAMPLE_YCAS_BANKS``) is (h, h + RPAD) with zero columns past the h + r
that carry weight: those pad columns serve the TPU's sublane alignment and
are dropped, which gives the port's YT (fft/dense.py::ycas_bank).  The
TPU's int8 digit banks and the bf16 hi|lo split of the y bank,
``ycasYT2``, have no counterpart and are dropped.  The tests use this to
feed both implementations the very same banks.

The c2c banks are plain float arrays and carry over as they are: the c2c
chain (``Xr``, ``Xi``, ``Yr``, ``Yi``, ``Yrpyi``) and the staged c2c grid
(``cg_ay``, ``cg_ax`` and every ``cgx{r}_``/``cgy{r}_`` stage bank); the
grid's ``qb``/``dc0`` entries serve the JAX package's experimental stage
codecs only and are dropped.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import resolve_device

_SPLIT = ("alpha", "alpha_odd")  # bf16 hi|lo pairs in the JAX row-split banks
_PLAIN = ("alpha", "Ymat_ns", "Ymat", "Y1n", "Y1", "beta",
          "Xr", "Xi", "Yr", "Yi", "Yrpyi", "cg_ay", "cg_ax")
_STAGE = ("_b1", "_m", "_b3")  # staged convolution banks of fft/staged.conv_banks


def _plain(key: str) -> bool:
    return key in _PLAIN or (key.startswith(("cgx", "cgy")) and key.endswith(_STAGE))


def banks_from_jax(banks: dict, device=None) -> dict:
    """JAX bank dict (numpy arrays) -> the port's float32 banks on `device`
    (default: the current CUDA device; RuntimeError without one)."""
    device = resolve_device(device)
    out = {}
    for key in banks:
        if _plain(key):
            out[key] = np.asarray(banks[key]).astype(np.float32)
    for key in _SPLIT:
        if key + "_hi" in banks:
            hi = np.asarray(banks[key + "_hi"]).astype(np.float32)
            out[key] = hi + np.asarray(banks[key + "_lo"]).astype(np.float32)
    if "ycasYT" in banks:
        # keep the h + r columns that carry weight: Ymat_ns is (h + r, h)
        h_r = np.shape(banks["Ymat_ns"])[0]
        out["ycasYT"] = np.asarray(banks["ycasYT"], np.float32)[:, :h_r]
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in out.items()
    }
