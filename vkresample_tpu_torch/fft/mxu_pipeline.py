"""The dense GEMM tier of the upscale transform (counterpart of
vkresample_tpu/fft/mxu_pipeline.py, which is named after the TPU's matrix
unit, the MXU).

On this card "MXU" means the GEMM forms of fft/dense.py and
fft/staged.py, run in float32 with TF32 off.  This module holds the small
dense tier (every axis <= DENSE_MAX): which bank set a plan gets, and the
woven pre-CAS image from those banks.  c2c plans take the staged grid form
(fft/staged.py) when c2c_grid_selected, else the dense c2c chain.  The
JAX module's r2c staged tiers (axes > DENSE_MAX), fp64 banks and its
mixed-radix fallback are not ported (ROADMAP.md modules items 6 and 8).
"""
from __future__ import annotations

import torch

from ..core.config import Precision
from ..core.plan import DENSE_MAX, UpscalePlan
from ..ops.weave import weave_grid
from . import dense, staged


def c2c_grid_selected(plan: UpscalePlan) -> bool:
    """c2c plans take the staged grid form (p^2 magnitude planes and a
    per-parity fused CAS) at every size where c2c_grid_params allows it,
    except below the dense cap with p > 4 (p^2 small planes and 2p bank
    sets), where the dense c2c chain serves."""
    if plan.r2c or plan.precision is Precision.DOUBLE:
        return False
    params = staged.c2c_grid_params(plan)
    if params is None:
        return False
    return not (max(plan.h, plan.w, plan.H, plan.W) <= DENSE_MAX and params[0] > 4)


def make_dense_banks(plan: UpscalePlan, dtype: str = "float32") -> dict:
    """Numpy banks of a plan in the small dense tier: for r2c the row-split
    set ("Ymat_ns" present) at integer u >= 2, the chain set ("Ymat")
    otherwise; for c2c the staged grid set ("cg_ay") when
    c2c_grid_selected, the c2c chain set ("Xr") otherwise
    (mxu_pipeline.py:189-197, 239-243)."""
    if max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        raise ValueError(f"the small dense tier takes plans up to {DENSE_MAX}: {plan}")
    if not plan.r2c:
        if c2c_grid_selected(plan):
            return staged.c2c_grid_staged_banks(plan, dtype)
        return dense.c2c_chain_banks(plan, dtype)
    if dense.r2c_rows_supported(plan):
        return dense.r2c_rows_banks(plan, dtype)
    return dense.r2c_chain_banks(plan, dtype)


def upscale_precas_mxu(x: torch.Tensor, plan: UpscalePlan, banks: dict) -> torch.Tensor:
    """(..., h, w) normalized image -> (..., H, W) pre-CAS image in CAS
    units (real values for r2c, the complex magnitude for c2c), from the
    device banks of make_dense_banks (mxu_pipeline.py:257-308)."""
    if "cg_ay" in banks:
        # the c2c grid's p^2 magnitude planes, woven back to the frame
        return weave_grid(staged.c2c_grid_staged(x * 255.0, banks), staged.c2c_grid_u(banks))
    if "Xr" in banks:
        return dense.c2c_chain(x, banks)
    if "Ymat_ns" in banks:
        # the row-split banks fold /255 in and expect raw 0..255 values
        U, O = dense.r2c_rows(x * 255.0, banks)
        return dense.weave_rows(U, O, plan.integer_upscale)
    return dense.r2c_chain(x, banks)
