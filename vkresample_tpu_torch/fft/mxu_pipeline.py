"""The dense GEMM tier of the upscale transform (counterpart of
vkresample_tpu/fft/mxu_pipeline.py, which is named after the TPU's matrix
unit, the MXU).

On this card "MXU" means the dense GEMM form of fft/dense.py, run as
float32 ``torch.matmul`` with TF32 off.  This module holds the small dense
tier only (every axis <= DENSE_MAX): which bank set a plan gets, and the
woven pre-CAS image from those banks.  The JAX module's staged circulant
and grid tiers (axes > DENSE_MAX, c2c, fp64) and its mixed-radix fallback
are not ported (ROADMAP.md modules items 6 and 8).
"""
from __future__ import annotations

import torch

from ..core.plan import DENSE_MAX, UpscalePlan
from . import dense


def make_dense_banks(plan: UpscalePlan, dtype: str = "float32") -> dict:
    """Numpy banks of an r2c plan in the small dense tier: the row-split
    set ("Ymat_ns" present) for integer u >= 2, the chain set ("Ymat"
    present) for every other factor (mxu_pipeline.py:239-243)."""
    if not plan.r2c or max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        raise ValueError(f"the small dense tier takes r2c plans up to {DENSE_MAX}: {plan}")
    if dense.r2c_rows_supported(plan):
        return dense.r2c_rows_banks(plan, dtype)
    return dense.r2c_chain_banks(plan, dtype)


def upscale_precas_mxu(x: torch.Tensor, plan: UpscalePlan, banks: dict) -> torch.Tensor:
    """(..., h, w) normalized image -> (..., H, W) pre-CAS image in CAS
    units, from the device banks of make_dense_banks
    (mxu_pipeline.py:297-308)."""
    if "Ymat_ns" in banks:
        # the row-split banks fold /255 in and expect raw 0..255 values
        U, O = dense.r2c_rows(x * 255.0, banks)
        return dense.weave_rows(U, O, plan.integer_upscale)
    return dense.r2c_chain(x, banks)
