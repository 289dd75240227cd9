"""Plain float64 reference of VkResample's upscale, in plain PyTorch.

It follows the reference program's math (DTolm/VkResample,
VkResample.cpp) and imports torch and numpy only, nothing of the port:

  1. uint8 -> float64, /255 per channel                 (:1644)
  2. forward 2-D FFT at the source size, unnormalized
  3. the spectrum moved into the zero-padded big spectrum (shift shader
     :516-545, zero band :1491-1502, band edges in float32 as the C code
     computes them)
  4. inverse 2-D FFT at the target size, normalized by 1/(H*W); r2c drops
     the imaginary parts of the DC and Nyquist columns, as a C2R does
  5. FidelityFX-CAS on the inverse scaled by upscale^2  (:1615, :887-923)
  6. x255, clamped, truncated to uint8                  (:1715)

It runs on whatever device its input lies on, one channel of one frame at
a time, so an 8K frame needs a few GB.  `store` is applied to the pre-CAS
image before CAS: the benchmark's control passes a rounding to a lower
storage precision there (see control_store).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def output_dims(h: int, w: int, upscale: float):
    """(H, W): the float32 products truncated, as the reference's uint32
    casts (:1417-1418)."""
    u = np.float32(upscale)
    return int(np.float32(h) * u), int(np.float32(w) * u)


def _band(n_big: int, upscale: float):
    """The zero band [left, right) of an axis of n_big, in float32 as
    (uint32)(N/(2u)) and (uint32)((2u-1)*N/(2u)) (:1494-1495)."""
    u = np.float32(upscale)
    two_u = np.float32(2.0) * u
    n = np.float32(n_big)
    return int(n / two_u), int((two_u - np.float32(1.0)) * n / two_u)


class Geometry:
    """The big spectrum's layout for an (h, w) frame upscaled by `upscale`."""

    def __init__(self, h: int, w: int, upscale: float, r2c: bool):
        self.h, self.w, self.upscale, self.r2c = h, w, float(upscale), bool(r2c)
        self.H, self.W = output_dims(h, w, upscale)
        y_left, y_right = _band(self.H, upscale)
        x_right = self.W // 2 if r2c else _band(self.W, upscale)[1]
        self.lo_y, self.hi_y = y_left, self.H - y_right
        self.lo_x = w // 2
        self.x_right = x_right
        self.hi_x = max(0, w // 2 + 1 - x_right) if r2c else self.W - x_right


def big_spectrum(Fs: torch.Tensor, g: Geometry) -> torch.Tensor:
    """The small spectrum (h, w//2+1) (r2c) or (h, w) (c2c) moved into the
    zero-padded big one, (H, W//2+1) or (H, W)."""
    H, W = g.H, g.W
    if g.r2c:
        G = torch.zeros((H, W // 2 + 1), dtype=Fs.dtype, device=Fs.device)
        cols = [(slice(0, g.lo_x), slice(0, g.lo_x))]
        if g.hi_x:  # identity-position columns above the band (u = 1)
            c = slice(g.x_right, g.x_right + g.hi_x)
            cols.append((c, c))
    else:
        G = torch.zeros((H, W), dtype=Fs.dtype, device=Fs.device)
        cols = [(slice(0, g.lo_x), slice(0, g.lo_x)),
                (slice(W - g.hi_x, W), slice(g.w - g.hi_x, g.w))]
    for dst, src in cols:
        G[:g.lo_y, dst] = Fs[:g.lo_y, src]
        if g.hi_y:
            G[H - g.hi_y:, dst] = Fs[g.h - g.hi_y:, src]
    return G


def _irfft2(G: torch.Tensor, H: int, W: int) -> torch.Tensor:
    t = torch.fft.ifft(G, n=H, dim=-2)
    t[..., 0].imag.zero_()
    if W % 2 == 0:
        t[..., W // 2].imag.zero_()
    return torch.fft.irfft(t, n=W, dim=-1)


def cas(ln: torch.Tensor, sharpen: float) -> torch.Tensor:
    """FidelityFX-CAS of an (H, W) image of lengths (:887-923), edges
    clamped; returns the sharpened image, not yet quantized."""
    ln = ln.clamp(0.0, 1.0)
    p = F.pad(ln[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    c, n, s = p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1]
    wv, e = p[1:-1, :-2], p[1:-1, 2:]
    nw, ne, sw, se = p[:-2, :-2], p[:-2, 2:], p[2:, :-2], p[2:, 2:]
    min_cross = torch.minimum(n, torch.minimum(wv, torch.minimum(c, torch.minimum(e, s))))
    max_cross = torch.maximum(n, torch.maximum(wv, torch.maximum(c, torch.maximum(e, s))))
    min_all = torch.minimum(min_cross, torch.minimum(nw, torch.minimum(ne, torch.minimum(sw, se))))
    max_all = torch.maximum(max_cross, torch.maximum(nw, torch.maximum(ne, torch.maximum(sw, se))))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)
    lo = minlen / (1.0 - minlen)
    hi = (1.0 - maxlen) / maxlen
    scale = torch.where(lo < hi, lo, hi)
    scale = torch.where(torch.isnan(scale), 0.0, scale)
    scale = -sharpen * torch.sqrt(scale.clamp_min(0.0))
    return (c + scale * (n + wv + e + s)) / (1.0 + 4.0 * scale)


def upscale_channel(x: torch.Tensor, g: Geometry, sharpen: float,
                    store: Optional[Callable] = None) -> torch.Tensor:
    """One (h, w) uint8 channel -> its (H, W) uint8 upscale."""
    f = x.to(torch.float64) / 255.0
    u2 = float(np.float32(g.upscale)) ** 2
    if g.r2c:
        pre = u2 * _irfft2(big_spectrum(torch.fft.rfft2(f), g), g.H, g.W)
    else:
        pre = torch.abs(u2 * torch.fft.ifft2(big_spectrum(torch.fft.fft2(f), g)))
    if store is not None:
        pre = store(pre)
    out = cas(torch.abs(pre), sharpen)
    return (out * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def upscale_frames(frames: torch.Tensor, config: dict,
                   store: Optional[Callable] = None) -> torch.Tensor:
    """(N, h, w, C) uint8 frames -> (N, C, H, W) uint8, on their device."""
    n, h, w, c = frames.shape
    g = Geometry(h, w, config["upscale"], config["r2c"])
    out = torch.empty((n, c, g.H, g.W), dtype=torch.uint8, device=frames.device)
    for i in range(n):
        for ch in range(c):
            out[i, ch] = upscale_channel(frames[i, :, :, ch], g, config["sharpen"], store)
    return out


def control_store(pre: torch.Tensor) -> torch.Tensor:
    """The control's storage: the pre-CAS image rounded to float8 e4m3, the
    8-bit step below the 16-bit storage that -p 2 states."""
    return pre.to(torch.float32).to(torch.float8_e4m3fn).to(torch.float64)
