"""The GEMM tier of the upscale transform (counterpart of
vkresample_tpu/fft/mxu_pipeline.py, which is named after the TPU's matrix
unit, the MXU).

On this card "MXU" means the GEMM forms of fft/dense.py and
fft/staged.py.  This module decides which bank set a plan gets
(bank_set, make_dense_banks, branch for branch JAX's make_dense_banks) and
makes the woven pre-CAS image from those banks (upscale_precas_mxu):

  staged64 / grid64 / c2cgrid64   -p 1 at every size where a staged form
                                  takes the plan: float64 staged banks of
                                  a few MB (dense f64 banks are O(n^2))
  c2cgrid   c2c, staged grid, at every size (below the cap p <= 4)
  grid      r2c integer u >= 3 or a fraction p/q above the cap
  staged    r2c u=2 above the cap: the staged quad
  rows / chain / c2c   the small dense tier (every axis <= DENSE_MAX), in
                       float32, or float64 for -p 1 where no staged form
                       applies
  fft       r2c u=2 at -p 0 / -p 2 on Engine.AUTO within the cap of a card
            whose row names the cuFFT tier (fft_tier_selected): the
            pruned cuFFT form (fft/cufft.py), which needs no banks

Above the cap a plan that no staged form takes has no bank set (None).
The JAX package then runs its mixed-radix phases route (integer factors)
or raises (fractional ones).  The port raises the same ValueError for a
fraction; an integer factor runs the reference tier instead (torch.fft,
then the woven CAS; pipeline/upscale.py), since cuFFT is the card's FFT
and the phases route is a TPU substitute for one.  That and the cuFFT
form below the cap on a card whose row names it (bank set "fft") are the
port's routing departures.  Not ported either: the int8 dense big quad
(VKRESAMPLE_BIG=int8) and the A/B knobs of the JAX module.

The cap between the two tiers is DENSE_MAX, or, on a card with a row in
core/tuning.py, the card's dense_max (plan.dense_max, which the entry
points fill).  The card's cap moves only the plan families whose two tiers
scripts/torch_dense_cap_sweep.py times (card_cap_applies): every other
plan keeps its route up to DENSE_MAX, the largest DFT matrix the dense
tier builds (above_cap).

Every staged bank set goes through the disk bank cache
(core/bankcache.py), as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..core.bankcache import get_or_build
from ..core.config import Engine, Precision
from ..core import plan as plan_mod
from ..core.plan import UpscalePlan
from ..ops.weave import weave_grid
from . import dense, staged


def card_cap_applies(plan: UpscalePlan) -> bool:
    """True when a card's cap (plan.dense_max) decides the plan's tier: the
    families scripts/torch_dense_cap_sweep.py times on both tiers at -p 0
    and -p 2, r2c u=2 that the staged quad takes (staged_supported) and
    r2c u=3 or 3/2 that the r2c grid takes (grid_supported).  The c2c
    grid, r2c u >= 4 and other fractions were not swept, and -p 1 takes
    its float64 staged sets at every size: they keep DENSE_MAX."""
    if plan.precision is Precision.DOUBLE or not plan.r2c:
        return False
    u = plan.integer_upscale
    if u == 2:
        return staged.staged_supported(plan)
    if u == 3 or (u is None and staged.frac_params(plan) == (3, 2)):
        return staged.grid_supported(plan)
    return False


def fft_tier_selected(plan: UpscalePlan) -> bool:
    """True when the plan takes the cuFFT form (fft/cufft.py) in place of
    the dense GEMM tier: its card's row names that tier (plan.dense_tier
    "fft", filled by core/tuning.py::plan_for with plan.dense_max), the
    engine is AUTO (-engine mxu keeps the GEMMs, -engine xla the reference
    tier), r2c u=2 at -p 0 or -p 2, and every axis within the card's cap.
    c2c, other factors, -p 1 and plans above the cap keep their routes."""
    return (plan.dense_tier == "fft" and plan.engine is Engine.AUTO and plan.r2c
            and plan.integer_upscale == 2 and plan.precision is not Precision.DOUBLE
            and plan.dense_max is not None
            and max(plan.h, plan.w, plan.H, plan.W) <= plan.dense_max)


def above_cap(plan: UpscalePlan) -> bool:
    """True when the plan is in the big tiers: past plan.dense_max (the
    card's cap) for a plan that card_cap_applies to, past DENSE_MAX
    (plan.above_dense_cap) for every other plan and where the plan has no
    cap of its own."""
    if plan.dense_max is None or not card_cap_applies(plan):
        return plan.above_dense_cap
    return max(plan.h, plan.w, plan.H, plan.W) > plan.dense_max


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
    return above_cap(plan) or params[0] <= 4


def big_grid_selected(plan: UpscalePlan) -> bool:
    """True when the plan takes a grid bank set (p x p phase planes): for
    c2c, c2c_grid_selected (at every size); for r2c, above the cap only,
    at integer u >= 3 or a fraction p/q that grid_supported takes (below
    the cap the dense tiers serve)."""
    if not plan.r2c:
        return c2c_grid_selected(plan)
    if plan.precision is Precision.DOUBLE or not above_cap(plan):
        return False
    u = plan.integer_upscale
    return ((u is not None and u >= 3) or (u is None and staged.frac_params(plan) is not None)) \
        and staged.grid_supported(plan)


def bank_set(plan: UpscalePlan) -> Optional[str]:
    """The tag of the bank set make_dense_banks builds for an MXU plan, or
    None when no bank set serves it (see the module docstring)."""
    if plan.precision is Precision.DOUBLE:
        if plan.r2c and staged.staged_supported(plan):
            return "staged64"
        if plan.r2c and staged.grid_supported(plan):
            return "grid64"
        if not plan.r2c and staged.c2c_grid_params(plan) is not None:
            return "c2cgrid64"
    if c2c_grid_selected(plan):
        return "c2cgrid"
    if big_grid_selected(plan):
        return "grid"
    if fft_tier_selected(plan):
        return "fft"
    if above_cap(plan):
        if plan.precision is not Precision.DOUBLE and staged.staged_supported(plan):
            return "staged"
        return None
    if not plan.r2c:
        return "c2c"
    return "rows" if dense.r2c_rows_supported(plan) else "chain"


# tag -> (builder, the dtype it builds in; None: the plan's compute dtype)
_BUILDERS = {
    "staged64": (staged.r2c_quad_staged_banks, "float64"),
    "grid64": (staged.r2c_grid_staged_banks, "float64"),
    "c2cgrid64": (staged.c2c_grid_staged_banks, "float64"),
    "c2cgrid": (staged.c2c_grid_staged_banks, "float32"),
    "grid": (staged.r2c_grid_staged_banks, "float32"),
    "staged": (staged.r2c_quad_staged_banks, "float32"),
    "rows": (dense.r2c_rows_banks, None),
    "chain": (dense.r2c_chain_banks, None),
    "c2c": (dense.c2c_chain_banks, None),
}


def make_dense_banks(plan: UpscalePlan, dtype: Optional[str] = None) -> Optional[dict]:
    """Numpy banks of an MXU plan (bank_set names the set; detect: "stx_b1"
    staged quad, "sgx1_b1" r2c grid, "cg_ay" c2c grid, "Ymat_ns" rows,
    "Ymat" chain, "Xr" c2c chain), through the disk bank cache; None when
    no bank set serves the plan or its form needs none (the cuFFT form).
    The dense sets are built in `dtype` (default: the plan's compute dtype,
    float64 for -p 1), the staged sets in their tag's."""
    tag = bank_set(plan)
    if tag not in _BUILDERS:
        return None
    build, built = _BUILDERS[tag]
    built = built or dtype or str(plan.precision.compute_dtype).removeprefix("torch.")
    return get_or_build(tag, plan, built, functools.partial(build, plan, built))


def big_fraction_error(plan: UpscalePlan) -> ValueError:
    """JAX's clean error for a fractional MXU plan above the cap that no
    staged grid takes: its big-spectrum mode does not survive there
    (vkresample_tpu/fft/mxu_pipeline.py:328-345)."""
    return ValueError(
        f"fractional upscale {plan.upscale} at {plan.h}x{plan.w} -> "
        f"{plan.H}x{plan.W} exceeds the dense-spectrum tier ({plan_mod.DENSE_MAX}) and "
        "does not match "
        "the staged fractional grid (needs H/h == W/w == p/q with q dividing both "
        "input dims and full-band keep); choose an upscale whose output dims are "
        "exact rational multiples, or an integer factor"
    )


def upscale_precas_mxu(x: torch.Tensor, plan: UpscalePlan, banks: dict) -> torch.Tensor:
    """(..., h, w) normalized image -> (..., H, W) pre-CAS image in CAS
    units (real values for r2c, the complex magnitude for c2c), from the
    device banks of make_dense_banks (mxu_pipeline.py:257-308).  The staged
    forms' planes are woven back to the frame: this is the -p 1 and the
    reference-check path; the fast routes consume the planes."""
    if "cg_ay" in banks:
        return weave_grid(staged.c2c_grid_staged(x * 255.0, banks), staged.c2c_grid_u(banks))
    if "stx_b1" in banks:
        return weave_grid(staged.r2c_quad_staged(x * 255.0, banks), 2)
    if "sgx1_b1" in banks:
        return weave_grid(staged.r2c_grid_staged(x * 255.0, banks), staged.grid_u(banks))
    if "Xr" in banks:
        return dense.c2c_chain(x, banks)
    if "Ymat_ns" in banks:
        # the row-split banks fold /255 in and expect raw 0..255 values
        U, O = dense.r2c_rows(x * 255.0, banks)
        return dense.weave_rows(U, O, plan.integer_upscale)
    return dense.r2c_chain(x, banks)

