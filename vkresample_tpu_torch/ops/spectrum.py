"""Spectrum relocation for the reference tier (counterpart of
vkresample_tpu/ops/spectrum.py).

The reference relocates the negative-frequency bins inside one big strided
buffer with its shift shader (VkResample.cpp:476-548); here the big
spectrum is assembled from static slices of the small one.
"""
from __future__ import annotations

import torch


def assemble_big_spectrum(F: torch.Tensor, plan) -> torch.Tensor:
    """Relocate the small spectrum F into the zero-padded big spectrum.

    F: (..., h, w//2+1) complex (r2c) or (..., h, w) complex (c2c).
    Returns (..., H, W//2+1) or (..., H, W).

    Rows [h - kept_hi_y, h) move to the far edge [H - kept_hi_y, H) (shift
    shader r2c branch, VkResample.cpp:521-525; c2c quadrant moves 527-545);
    bins inside the inverse's zero band (VkResample.cpp:1491-1502) are
    dropped, which for r2c kills the source Nyquist column w/2 unless u = 1.
    """
    H, W = plan.H, plan.W
    klo_y, khi_y = plan.kept_lo_y, plan.kept_hi_y
    lead = F.shape[:-2]
    if plan.r2c:
        G = torch.zeros(lead + (H, W // 2 + 1), dtype=F.dtype, device=F.device)
        kx, kxh, xr = plan.kept_lo_x, plan.kept_hi_x, plan.x_right
        cols = [(slice(0, kx), slice(0, kx))]
        if kxh:  # identity-position columns above the band (u = 1)
            cols.append((slice(xr, xr + kxh), slice(xr, xr + kxh)))
    else:
        G = torch.zeros(lead + (H, W), dtype=F.dtype, device=F.device)
        kxl, kxh = plan.kept_lo_x, plan.kept_hi_x
        cols = [(slice(0, kxl), slice(0, kxl))]
        if kxh:
            cols.append((slice(W - kxh, W), slice(plan.w - kxh, plan.w)))
    for dst, src in cols:
        G[..., :klo_y, dst] = F[..., :klo_y, src]
        if khi_y:
            G[..., H - khi_y:, dst] = F[..., plan.h - khi_y:, src]
    return G
