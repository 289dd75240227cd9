"""Pure NumPy fp64 oracle of the full upscale pipeline.

A copy of vkresample_tpu/oracle/numpy_ref.py that imports neither jax nor
the JAX package, so the port can validate on a machine without JAX.  It
must equal the JAX package's oracle bit for bit (tests/test_torch_plan.py).

Pipeline (the reference GPU pipeline's math):
  1. uint8 -> float, /255 per channel             (VkResample.cpp:1644)
  2. forward 2D FFT at source size, unnormalized
  3. spectrum relocation into the zero-padded big spectrum (shift shader,
     VkResample.cpp:516-545) with the inverse pass's zero band
     (VkResample.cpp:1491-1502)
  4. inverse 2D FFT at target size, normalized by 1/(H*W)
  5. FidelityFX-CAS sharpen with inputs pre-scaled by upscale^2
     (VkResample.cpp:1615; CAS math VkResample.cpp:887-923)
  6. x255, truncate to uint8                      (VkResample.cpp:1715)
"""
from __future__ import annotations

import numpy as np

from ..core.plan import UpscalePlan


def assemble_big_spectrum(F: np.ndarray, plan: UpscalePlan) -> np.ndarray:
    """Relocate the small spectrum F into the zero-padded big spectrum.

    F: (h, w//2+1) complex for r2c, (h, w) complex for c2c.
    Returns (H, W//2+1) or (H, W) complex.
    """
    H, W = plan.H, plan.W
    klo_y, khi_y = plan.kept_lo_y, plan.kept_hi_y
    if plan.r2c:
        G = np.zeros((H, W // 2 + 1), dtype=F.dtype)
        kx = plan.kept_lo_x
        kxh = plan.kept_hi_x  # identity-position cols above the band (u=1)
        G[:klo_y, :kx] = F[:klo_y, :kx]
        if kxh:
            G[:klo_y, plan.x_right : plan.x_right + kxh] = F[
                :klo_y, plan.x_right : plan.x_right + kxh
            ]
        if khi_y:
            G[H - khi_y :, :kx] = F[plan.h - khi_y :, :kx]
            if kxh:
                G[H - khi_y :, plan.x_right : plan.x_right + kxh] = F[
                    plan.h - khi_y :, plan.x_right : plan.x_right + kxh
                ]
    else:
        G = np.zeros((H, W), dtype=F.dtype)
        kxl, kxh = plan.kept_lo_x, plan.kept_hi_x
        G[:klo_y, :kxl] = F[:klo_y, :kxl]
        G[:klo_y, W - kxh :] = F[:klo_y, plan.w - kxh :]
        if khi_y:
            G[H - khi_y :, :kxl] = F[plan.h - khi_y :, :kxl]
            G[H - khi_y :, W - kxh :] = F[plan.h - khi_y :, plan.w - kxh :]
    return G


def cas_sharpen(v: np.ndarray, sharpen: float, magnitude: bool) -> np.ndarray:
    """FidelityFX-CAS sharpen, exact reference math (VkResample.cpp:887-923).

    v: (H, W) real (r2c) or complex (c2c, magnitude=True), already
       pre-scaled by upscale^2.  Returns the sharpened image, not yet
       clamped or quantized.
    """
    ln = np.abs(v)  # GLSL length() == abs for real and complex
    ln = np.clip(ln, 0.0, 1.0)

    p = np.pad(ln, 1, mode="edge")  # clamp-to-edge neighbor indexing
    c = p[1:-1, 1:-1]
    n = p[:-2, 1:-1]
    s = p[2:, 1:-1]
    wv = p[1:-1, :-2]
    e = p[1:-1, 2:]
    nw = p[:-2, :-2]
    ne = p[:-2, 2:]
    sw = p[2:, :-2]
    se = p[2:, 2:]

    # two-level min/max: cross first, then corners (VkResample.cpp:908-916)
    min_cross = np.minimum(n, np.minimum(wv, np.minimum(c, np.minimum(e, s))))
    min_all = np.minimum(min_cross, np.minimum(nw, np.minimum(ne, np.minimum(sw, se))))
    max_cross = np.maximum(n, np.maximum(wv, np.maximum(c, np.maximum(e, s))))
    max_all = np.maximum(max_cross, np.maximum(nw, np.maximum(ne, np.maximum(sw, se))))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)

    with np.errstate(divide="ignore", invalid="ignore"):
        lo = minlen / (1.0 - minlen)
        hi = (1.0 - maxlen) / maxlen
        scale = np.where(lo < hi, lo, hi)
        scale = np.where(np.isnan(scale), 0.0, scale)
        scale = -sharpen * np.sqrt(np.maximum(scale, 0.0))

    out = (c + scale * (n + wv + e + s)) / (1.0 + 4.0 * scale)
    return out


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """255*x truncated to uint8.  The reference C-casts without clamping
    (UB out of range, VkResample.cpp:1715); we clamp then truncate."""
    return np.clip(x * 255.0, 0.0, 255.0).astype(np.uint8)


def upscale_oracle(
    img: np.ndarray, plan: UpscalePlan, dtype=np.float64
) -> np.ndarray:
    """Full-pipeline oracle.  img: (h, w, C) uint8.  Returns (H, W, C) uint8."""
    h, w, C = img.shape
    if (h, w) != (plan.h, plan.w):
        raise ValueError(f"image {img.shape} does not match plan {plan}")
    u2 = float(np.float32(plan.upscale)) ** 2
    out = np.empty((plan.H, plan.W, C), np.uint8)
    for ch in range(C):
        f = img[:, :, ch].astype(dtype) / 255.0
        if plan.r2c:
            F = np.fft.rfft2(f)
            G = assemble_big_spectrum(F, plan)
            y = np.fft.irfft2(G, s=(plan.H, plan.W))
            sharp = cas_sharpen(u2 * y, plan.sharpen, magnitude=False)
        else:
            F = np.fft.fft2(f)
            G = assemble_big_spectrum(F, plan)
            y = np.fft.ifft2(G)
            sharp = cas_sharpen(u2 * y, plan.sharpen, magnitude=True)
        out[:, :, ch] = quantize_u8(sharp)
    return out

