"""The cuFFT form of the pre-CAS transform, r2c u = 2 (the port's own: the
JAX package runs its dense GEMMs here and its FFT only on the reference
tier).

On a card whose row in core/tuning.py names the cuFFT tier below its dense
cap (DeviceTuning.dense_tier = "fft"), an r2c u = 2 plan at -p 0 or -p 2
with every axis within that cap runs this form in place of the dense GEMM
quad (fft/dense.py::r2c_quad) on Engine.AUTO (fft/mxu_pipeline.py::
fft_tier_selected).  A DFT as a matrix product costs O(N) operations per
output value, an FFT O(log N): on the H100 this form is bound by memory.
Like VkResample's own inverse (SURVEY.md section 0, steps 3-5) it never
fills or transforms the zero band:

  1. rfft2 of the frame, raw uint8 values cast to float32 (the 1/255 goes
     into the store);
  2. the spectrum shift (ops/fft_cuda.py::spectrum_shift, one pass, the
     counterpart of VkResample's shift shader) written straight into an
     (..., H, kept_lo_x) buffer that holds only the kept columns: rows
     [0, kept_lo_y) in place, the last kept_hi_y rows of the small spectrum
     at the far edge, the zero band's rows zeroed (ops/spectrum.py::
     assemble_big_spectrum keeps the same bins; at u = 2 the source
     Nyquist column is in the band);
  3. ifft along y on those columns (the buffer is stored y innermost, so
     torch.fft runs it without copying it to that layout first);
  4. the pad (ops/fft_cuda.py::spectrum_pad, one pass): back to row-major,
     zero-padded to the W/2 + 1 columns of the C2R (the x-Nyquist column
     lies in the zero band at u = 2), the imaginary part of column 0
     zeroed, as pipeline/upscale.py::_irfft2 does (the relocated y-Nyquist
     row leaves it non-Hermitian); then the C2R along x (ops/fft_cuda.py::
     c2r: cuFFT on the card, called directly, since torch.fft.irfft copies
     its input first, a pass of 8 bytes a bin that this temporary does not
     need);
  5. the one-pass store (ops/fft_cuda.py::quad_store): the scale, that is
     the 1/255 of the input, the u^2 factor and the inverses' 1/(H W)
     (both run unnormalized), and Q2.14's 2^14 at -p 2, rounded half to
     even and saturated as ops/cas.py::to_i16_storage; and the split into
     the four parity planes that K1 (ops/cas_cuda.py::
     cas_parity4_planes_u2) reads.

Leading frame dims broadcast: a batch runs each cuFFT call once.  The
transforms are float32, as the reference tier's (pipeline/upscale.py::
_precas_xla).  r2c_quad_fft.calls counts the calls, so a run can show that
the route engaged.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import Precision
from ..ops.fft_cuda import c2r, quad_store, spectrum_pad, spectrum_shift
from ..utils.profiling import span


def store_scale(plan) -> float:
    """The factor from the unnormalized inverses' output, in raw uint8
    units, to CAS units: u^2 / (255 H W), rounded once to float32 (u^2
    taken in float32 as the reference tier does)."""
    u2 = float(np.float32(np.float32(plan.upscale) ** 2))
    return float(np.float32(u2 / (255.0 * plan.H * plan.W)))


def r2c_quad_fft(x_raw: torch.Tensor, plan):
    """(..., h, w) uint8 (raw values) -> the four pre-CAS parity planes
    P[ry][rx] (..., h, w) of an r2c u = 2 plan in CAS units: int16 Q2.14 at
    -p 2, float32 at -p 0 (plan.precision)."""
    if plan.integer_upscale != 2 or not plan.r2c or plan.precision is Precision.DOUBLE:
        raise ValueError(f"the cuFFT form takes r2c u = 2 at -p 0 or -p 2: {plan}")
    r2c_quad_fft.calls += 1
    H, W = plan.H, plan.W
    kx, klo, khi = plan.kept_lo_x, plan.kept_lo_y, plan.kept_hi_y
    with span("vkr.precas.fft"):
        F = torch.fft.rfft2(x_raw.to(torch.float32))  # (..., h, w//2 + 1)
        G = spectrum_shift(F.contiguous(), H, kx, klo, khi)  # stored y innermost
        del F
        # norm="forward": both inverses unscaled, their 1/(H W) folded into
        # the store (store_scale) instead of two passes over the data
        g = torch.fft.ifft(G, dim=-2, norm="forward")
        del G
        P = spectrum_pad(g, W // 2 + 1)  # Im of column 0 zeroed
        del g
        v = c2r(P, W)  # overwrites P, a temporary
        del P
    i16 = plan.precision is Precision.HALF
    if not i16:
        return quad_store(v, store_scale(plan), False)
    with span("vkr.codec"):
        return quad_store(v, store_scale(plan), True)


r2c_quad_fft.calls = 0
