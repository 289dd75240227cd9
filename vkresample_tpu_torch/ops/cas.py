"""FidelityFX-CAS sharpen and the pre-CAS storage codec, in plain torch
(counterpart of vkresample_tpu/ops/cas.py).

Reference shader: VkResample.cpp:887-923.  Inputs are pre-scaled by
upscale^2, clamped to [0, 1]; a two-level min/max over the cross and corner
neighbourhoods drives the adaptive sharpening weight

    scale = -s * sqrt(min(minl/(1-minl), (1-maxl)/maxl))
    out   = (c + scale * sum(cross)) / (1 + 4*scale)

The fused CAS + quantize kernels (quad, rows-parity, woven) and their plain
versions live in ops/cas_cuda.py; cas_quantize_banded is the float64 CAS of
the -p 1 routes, in bounded memory.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span


def cas_sharpen(v: torch.Tensor, sharpen: float) -> torch.Tensor:
    """Sharpen over the last two axes (..., H, W) of a woven image.

    v: real or complex, already scaled by upscale^2.  Returns the real
    image, same leading axes, not yet clamped or quantized.
    """
    ln = torch.clamp(v.abs(), 0.0, 1.0)  # complex magnitude or real abs
    lead = ln.shape[:-2]
    flat = ln.reshape((-1, 1) + ln.shape[-2:])
    p = F.pad(flat, (1, 1, 1, 1), mode="replicate").reshape(
        lead + (ln.shape[-2] + 2, ln.shape[-1] + 2)
    )
    c = p[..., 1:-1, 1:-1]
    n = p[..., :-2, 1:-1]
    s = p[..., 2:, 1:-1]
    w = p[..., 1:-1, :-2]
    e = p[..., 1:-1, 2:]
    nw = p[..., :-2, :-2]
    ne = p[..., :-2, 2:]
    sw = p[..., 2:, :-2]
    se = p[..., 2:, 2:]

    mn, mx = torch.minimum, torch.maximum
    min_cross = mn(n, mn(w, mn(c, mn(e, s))))
    min_all = mn(min_cross, mn(nw, mn(ne, mn(sw, se))))
    max_cross = mx(n, mx(w, mx(c, mx(e, s))))
    max_all = mx(max_cross, mx(nw, mx(ne, mx(sw, se))))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)

    lo = minlen / (1.0 - minlen)
    hi = (1.0 - maxlen) / maxlen
    sc = torch.where(lo < hi, lo, hi)
    sc = torch.where(torch.isnan(sc), torch.zeros_like(sc), sc)
    sc = -sharpen * torch.sqrt(torch.clamp(sc, min=0.0))
    return (c + sc * (n + w + e + s)) / (1.0 + 4.0 * sc)


# elements of one band of cas_quantize_banded: cas_sharpen holds about 25
# temporaries of its input's size, so a band of 2^24 float64 elements peaks
# near 3.4 GB
BAND_ELEMS = 1 << 24


def cas_quantize_banded(v: torch.Tensor, sharpen: float, band_rows: int = None) -> torch.Tensor:
    """quantize_u8(cas_sharpen(v, sharpen)) over (..., H, W), in row bands
    so that the peak memory stays that of one band: each band of band_rows
    output rows runs cas_sharpen on its rows and one real halo row above
    and below (replicate-padded only at the image's own edges), and keeps
    its own rows.  Every pixel sees the same neighbours as in the whole
    image, so the result is identical to the whole-image form.  This is
    the -p 1 routes' CAS (the JAX package keeps float64 CAS off its kernels
    too).  band_rows defaults to the rows that fit BAND_ELEMS elements."""
    H = v.shape[-2]
    if band_rows is None:
        band_rows = max(1, BAND_ELEMS // max(1, v[..., 0, :].numel()))
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    for r0 in range(0, H, band_rows):
        r1 = min(r0 + band_rows, H)
        a = max(r0 - 1, 0)
        band = cas_sharpen(v[..., a:min(r1 + 1, H), :], sharpen)
        out[..., r0:r1, :] = quantize_u8(band[..., r0 - a:r1 - a, :])
    return out


# ---------------------------------------------------------------------------
# 16-bit fixed-point pre-CAS storage (the -p 2 "half memory" mode)
# ---------------------------------------------------------------------------
#
# CAS clips |v| to [0, 1] before any arithmetic, so a Q2.14 integer keeps
# ~14 bits of the useful range at the bytes of the reference's fp16
# storage.  Max quantization error ~3e-5 in v units (~0.008 u8 LSB).

I16_SCALE = 16384.0  # Q2.14: covers [-2, 2); CAS clips to [0, 1] anyway


def to_i16_storage(x: torch.Tensor) -> torch.Tensor:
    """float pre-CAS values -> int16 Q2.14 (round half to even, saturating,
    as jnp.round)."""
    with span("vkr.codec"):
        return torch.clamp(
            torch.round(x.to(torch.float32) * I16_SCALE), -32768.0, 32767.0
        ).to(torch.int16)


def from_i16_storage(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int16 Q2.14 -> float (inverse of to_i16_storage)."""
    with span("vkr.codec"):
        return x.to(dtype) * (1.0 / I16_SCALE)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """255*x, clamped, truncated to uint8 (the reference casts unclamped,
    VkResample.cpp:1715; we clamp)."""
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def normalize_u8(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 -> float in [0, 1] (reference host marshal /255,
    VkResample.cpp:1644)."""
    return img.to(dtype) / 255.0
