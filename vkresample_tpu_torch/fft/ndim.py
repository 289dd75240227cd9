"""N-dimensional FFT over (re, im) pairs (counterpart of
vkresample_tpu/fft/ndim.py).

The reference engine supports 1-3D transforms (VkFFTConfiguration.FFTdim,
vkFFT.h:23); VkResample itself only uses 2D.  The JAX package builds them
on its mixed-radix MXU engine; here torch.fft (cuFFT on the card) does the
transforms, behind the JAX package's pair interface and conventions:

  * forward unnormalized; inverse normalized by 1/N unless ``normalize``
    says otherwise (VkFFT's normalize=1);
  * every transformed axis must factor into composites <= ``max_factor``
    of {2, 3, 5, 7} (core/smooth.py::plan_factors), the JAX engine's size
    contract, with its ValueError;
  * ``irfftn`` ignores Im(DC) and, for an even last axis, Im(Nyquist) of
    each row of the half spectrum, as numpy's irfft does.

The entry points run on the current CUDA device unless the caller names
another (``device="cpu"``); inputs move there and results stay there.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.config import resolve_device
from ..core.smooth import plan_factors

Pair = Tuple[torch.Tensor, torch.Tensor]


def as_real(x, device) -> torch.Tensor:
    """x (numpy array or tensor) on `device`; non-float dtypes as float32,
    as jnp.fft promotes them."""
    x = torch.as_tensor(x, device=device)
    return x if x.is_floating_point() else x.to(torch.float32)


def _check_sizes(shape, axes, max_factor: int) -> None:
    """The JAX engine's size contract: each transformed axis of length > 1
    factors over the radix set (vkresample_tpu/fft/mixed_radix.py:132)."""
    for ax in axes:
        if shape[ax] != 1:
            plan_factors(int(shape[ax]), max_factor)


def _fft_complex(z: torch.Tensor, axes, inverse: bool, normalize: bool) -> torch.Tensor:
    """torch.fft over `axes` (each axis in turn where one repeats, as the
    JAX package transforms axis by axis).  norm: the forward transform is
    unnormalized ("backward"); the inverse scales by 1/N ("backward") or
    not at all ("forward")."""
    dims = [ax % z.ndim for ax in axes]
    if not dims:
        return z
    fn = torch.fft.ifftn if inverse else torch.fft.fftn
    norm = "backward" if normalize or not inverse else "forward"
    if len(set(dims)) == len(dims):
        return fn(z, dim=dims, norm=norm)
    for d in dims:
        z = fn(z, dim=(d,), norm=norm)
    return z


def _pair(z: torch.Tensor) -> Pair:
    return z.real.contiguous(), z.imag.contiguous()


def fftn(
    x: Pair,
    axes: Sequence[int] = (-2, -1),
    inverse: bool = False,
    normalize: bool | None = None,
    max_factor: int = 128,
    device=None,
) -> Pair:
    """Complex N-D FFT of a (re, im) pair over `axes`.

    Forward unnormalized; inverse normalized by 1/N per axis (VkFFT
    convention, normalize=1) unless overridden.
    """
    if normalize is None:
        normalize = inverse
    dev = resolve_device(device)
    xr, xi = as_real(x[0], dev), as_real(x[1], dev)
    _check_sizes(xr.shape, axes, max_factor)
    return _pair(_fft_complex(torch.complex(xr, xi), axes, inverse, normalize))


def rfftn(
    x, axes: Sequence[int] = (-2, -1), max_factor: int = 128, device=None
) -> Pair:
    """Real N-D forward FFT: R2C along the last of `axes`, complex along
    the rest.  Returns the half spectrum over the final axis."""
    x = as_real(x, resolve_device(device))
    if axes[-1] % x.ndim != x.ndim - 1:
        raise ValueError("rfftn requires the real axis to be the last axis")
    _check_sizes(x.shape, axes, max_factor)
    z = torch.fft.rfft(x, dim=-1)
    return _pair(_fft_complex(z, axes[:-1], inverse=False, normalize=False))


def irfftn(
    X: Pair,
    s: Tuple[int, ...],
    axes: Sequence[int] = (-2, -1),
    max_factor: int = 128,
    device=None,
) -> torch.Tensor:
    """Inverse of rfftn (normalized), output shape `s` over `axes`.

    The complex inverse runs over axes[:-1] first; then Im(DC) and, for an
    even last axis, Im(Nyquist) of each row are zeroed before the 1-D C2R
    over the last axis, in the JAX package's order (ndim.py:90-103,
    rfft2.py:153-165): the result then does not rest on how cuFFT treats a
    half spectrum that is not Hermitian."""
    dev = resolve_device(device)
    Xr, Xi = as_real(X[0], dev), as_real(X[1], dev)
    w = int(s[-1])
    _check_sizes(Xr.shape, axes[:-1], max_factor)
    if w != 1:
        plan_factors(w, max_factor)
    g = _fft_complex(torch.complex(Xr, Xi), axes[:-1], inverse=True, normalize=True)
    g = g[..., : w // 2 + 1].clone()
    g[..., 0].imag.zero_()
    if w % 2 == 0:
        g[..., w // 2].imag.zero_()
    return torch.fft.irfft(g, n=w, dim=-1)
