"""vkresample_tpu_torch — PyTorch/CUDA port of vkresample-tpu for NVIDIA
Hopper (H100).

The JAX package ``vkresample_tpu`` stays beside it as the reference.  This
package imports torch and numpy only, never jax or vkresample_tpu, and
builds its CUDA kernels (csrc/) with nvcc at first launch, never at import.

Ported slice: the u=2 R2C upscale with CAS sharpen in fp32 (-p 0) and
half storage (-p 2), uint8 image -> uint8 parity planes -> PNG, widths a
multiple of 128, every axis <= 8192.  Other plans raise NotImplementedError
naming their ROADMAP.md item.

Public API:
    upscale(img, upscale, precision=..., sharpen=...) -> (H, W, C) uint8
    build_upscale(plan, device, planes_out=...) -> per-frame function
    UpscalePlan, Precision
"""

__version__ = "0.1.0"

from .core.config import Precision  # noqa: F401
from .core.plan import UpscalePlan  # noqa: F401
from .pipeline.upscale import build_upscale, upscale  # noqa: F401
