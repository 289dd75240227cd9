"""Frequency-domain convolution, the VkFFT engine's convolution surface
(counterpart of vkresample_tpu/ops/convolve.py).

The reference engine fuses a convolution step between its forward and
inverse transforms (vkFFT.h:45-48 config, codegen 3157-3517): an
elementwise spectrum multiply, multi-kernel batching (numberKernels) and
matrix convolution across coordinate features.  VkResample never calls
it; it is part of the engine surface.  Circular semantics, as the
reference's; ``fft_convolve2d_linear`` zero-pads for linear convolution.

Engines, flag-compatible with the JAX package:
  * "xla" and "mxu" both transform with torch.fft (cuFFT on the card).
    "mxu" keeps the JAX engine's contract: every axis must be 7-smooth
    (ValueError otherwise), and kernel_spectrum gives its spectra as
    (re, im) pairs;
  * "auto" resolves to "xla", as the JAX package's default does.  The JAX
    package also sends a concrete separable kernel of the frame's size
    through its staged transform banks on "auto"; the port does not, since
    on an H100 that route lost to cuFFT at every shape measured
    (PERF.md §6).

The matrix convolution's complex einsum runs in full fp32 on the card
(core/config.py::fp32_matmul), as the JAX package runs it at HIGHEST.  The
entry points run on the current CUDA device unless the caller names
another (``device="cpu"``); inputs move there and results stay there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import fp32_matmul, resolve_device
from ..core.smooth import is_7smooth
from ..fft.ndim import as_real, rfftn

MAX_FACTOR = 128  # engine radix cap (core/smooth.py composite radixes)


def _engine_ok(*dims: int, max_factor: int = MAX_FACTOR) -> bool:
    """True when every axis factors over the engine's radix set:
    7-smooth, like the reference engine (vkFFT.h:4716-4726)."""
    return all(is_7smooth(int(n)) for n in dims)


def _resolve_engine(engine: str, h: int, w: int) -> str:
    if engine == "auto":
        return "xla"
    if engine == "mxu" and not _engine_ok(h, w):
        raise ValueError(
            f"{h}x{w} does not factor over the engine radix set (<= "
            f"{MAX_FACTOR}); use engine='xla'"
        )
    return engine


def kernel_spectrum(kernel, engine: str = "auto", device=None):
    """Forward-transform a convolution kernel once (plan-time analog of
    VkFFT's kernel upload+transform).  Returns an engine-tagged spectrum
    consumable by fft_convolve2d: ("mxu", (re, im)) or ("xla", complex)."""
    dev = resolve_device(device)
    kernel = as_real(kernel, dev)
    eng = _resolve_engine(engine, kernel.shape[-2], kernel.shape[-1])
    if eng == "mxu":
        return ("mxu", rfftn(kernel, axes=(-2, -1), max_factor=MAX_FACTOR, device=dev))
    return ("xla", torch.fft.rfft2(kernel))


def _bank_shape(spec: torch.Tensor, nd: int):
    """A (K, h, w2) bank's view that broadcasts over an (..., h, w2)
    spectrum of rank nd: the output gains a leading K axis."""
    return spec.shape[:1] + (1,) * (nd - 2) + spec.shape[1:]


def fft_convolve2d(x, kernel, engine: str = "auto", device=None) -> torch.Tensor:
    """Circular 2D convolution via the frequency domain.

    x:      (..., h, w) real.
    kernel: (h, w): one kernel broadcast over leading dims, or
            (K, h, w): K kernels (VkFFT numberKernels batching), the
            output gains a leading K axis.  A kernel_spectrum() result is
            also accepted.
    engine: "auto" (resolves to "xla"), "mxu" (7-smooth axes only) or
            "xla"; all three multiply torch.fft spectra.
    """
    dev = resolve_device(device)
    x = as_real(x, dev)
    h, w = x.shape[-2], x.shape[-1]
    if isinstance(kernel, tuple) and kernel[0] in ("mxu", "xla"):
        eng, K = kernel
        _resolve_engine(eng, h, w)  # the mxu size contract
    else:
        eng, K = kernel_spectrum(as_real(kernel, dev).to(x.dtype), engine, device=dev)
    K = (torch.complex(*K) if eng == "mxu" else K).to(dev)
    X = torch.fft.rfft2(x)
    if K.ndim == 2:
        return torch.fft.irfft2(X * K, s=(h, w))
    return torch.fft.irfft2(K.reshape(_bank_shape(K, X.ndim)) * X[None], s=(h, w))


def fft_matrix_convolve2d(x, kernel, engine: str = "auto", device=None) -> torch.Tensor:
    """Matrix convolution over coordinate features (vkFFT matrixConvolution,
    vkFFT.h:46: 2x2/3x3 supported there; any square size here).

    x:      (..., C, h, w): C coordinate features.
    kernel: (Cout, Cin, h, w) with Cin == C.
    Returns (..., Cout, h, w): out[o] = sum_i kernel[o, i] (*) x[i].
    """
    dev = resolve_device(device)
    x = as_real(x, dev)
    kernel = as_real(kernel, dev).to(x.dtype)
    C = x.shape[-3]
    if kernel.shape[1] != C:
        raise ValueError(f"kernel Cin {kernel.shape[1]} != x features {C}")
    h, w = x.shape[-2], x.shape[-1]
    _resolve_engine(engine, h, w)  # the mxu size contract
    X = torch.fft.rfft2(x)  # (..., C, h, w2)
    Kf = torch.fft.rfft2(kernel)  # (Cout, Cin, h, w2)
    with fp32_matmul():
        Y = torch.einsum("oihw,...ihw->...ohw", Kf, X)
    return torch.fft.irfft2(Y, s=(h, w))


def _smooth_up(n: int, max_factor: int = MAX_FACTOR) -> int:
    """Smallest m >= n that factors over the engine radix set."""
    m = int(n)
    while not _engine_ok(m, max_factor=max_factor):
        m += 1
    return m


def fft_convolve2d_linear(x, kernel, engine: str = "auto", device=None) -> torch.Tensor:
    """LINEAR (non-circular) 2D convolution via spatial zero-padding, the
    vkFFT spatial zero-pad capability (frequencyZeroPadding=0 default,
    vkFFT.h:37-39): both operands are zero-extended to a common 7-smooth
    size >= h+hk-1 so wraparound never aliases, convolved circularly, and
    cropped to the 'full' extent (h+hk-1, w+wk-1).

    x: (..., h, w) real; kernel: (hk, wk).
    """
    dev = resolve_device(device)
    x = as_real(x, dev)
    kernel = as_real(kernel, dev).to(x.dtype)
    h, w = x.shape[-2], x.shape[-1]
    hk, wk = kernel.shape[-2], kernel.shape[-1]
    H = _smooth_up(h + hk - 1)
    W = _smooth_up(w + wk - 1)
    xp = F.pad(x, (0, W - w, 0, H - h))
    kp = F.pad(kernel, (0, W - wk, 0, H - hk))
    out = fft_convolve2d(xp, kp, engine=engine, device=dev)
    return out[..., : h + hk - 1, : w + wk - 1]


def gaussian_kernel(h: int, w: int, sigma: float, dtype=np.float32) -> np.ndarray:
    """Centered periodic Gaussian kernel, unit mass: a convenience for the
    convolution surface (blur/AA filters)."""
    y = np.minimum(np.arange(h), h - np.arange(h))[:, None]
    x = np.minimum(np.arange(w), w - np.arange(w))[None, :]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(dtype)
