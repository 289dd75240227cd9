"""Copy-quantize kernels (K10): the woven CAS kernels' data movement with the
CAS arithmetic taken out; their wrappers and plain PyTorch version.

Counterpart of scripts/cas_split.py::copy_quantize, the JAX script's probe
that keeps cas_quantize_pallas's band DMA and replaces its CAS with a plain
quantize, so that timing the two side by side splits the CAS's cost into
data movement and arithmetic.  There is one form for each data-movement
design of the port's woven CAS kernels:

  K10a copy_quantize_tile  the shared tile of K3's first design (retired
                           when K3 moved onto csrc/cas_rows.cu's kernel;
                           kept as the JAX probe's port), csrc/copy_quantize.cu
  K10b copy_quantize_mono  K7's persistent, warp-specialized streaming
                           pipeline (csrc/cas_mono.cu,
                           csrc/stream_pipeline.cuh), csrc/copy_quantize.cu
  K10c copy_quantize_rows  the copy-only instance of csrc/cas_rows.cu's
                           kernel, the data movement of K5, K3 and K2 (its
                           staging and register walk, the centre quantized
                           where the kernel evaluates the CAS)

All three compute ops/cas.py::quantize_u8 of a float32 (..., H, W) image,
for every H, W and block_rows >= 1; they are on no route, as in the JAX
package.  Each wrapper runs its kernel on a CUDA tensor (on the current
stream; a launch error raises) and the plain version on a CPU tensor, and
counts its kernel launches in ``.launches``; K10b also records in
``.staging`` the copy form of its last launch (``cas_cuda.stream_form``).
"""
from __future__ import annotations

import torch

from .cas_cuda import _block_rows, _check_f32, _launch, stream_form

FORMS = ("tile", "mono", "rows")


def copy_quantize_reference(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of every form, on any device: (..., H, W)
    float32 -> uint8, (int)clamp(v * 255, 0, 255)."""
    _check_f32("copy quantize", v)
    return torch.clamp(v * 255.0, 0.0, 255.0).to(torch.uint8)


def _launch_on(entry: str, v: torch.Tensor, *extra):
    """(out, launched): the uint8 output of the C entry point on v (C, H, W
    and the extra arguments), not launched for an empty v."""
    H, W = v.shape[-2:]
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    if v.numel() == 0:
        return out, False
    _launch(entry, v.device, v.data_ptr(), out.data_ptr(), v.numel() // (H * W), H, W, *extra)
    return out, True


def copy_quantize_tile(v: torch.Tensor) -> torch.Tensor:
    """K10a: quantize a float32 (..., H, W) image to uint8 through K3's tile
    staging.  CUDA tensors go through csrc/copy_quantize.cu, CPU tensors
    take the plain version."""
    _check_f32("copy quantize", v)
    if v.device.type == "cpu":
        return copy_quantize_reference(v)
    out, launched = _launch_on("vkr_copy_quantize_tile", v)
    copy_quantize_tile.launches += launched
    return out


copy_quantize_tile.launches = 0


def copy_quantize_mono(v: torch.Tensor, block_rows: int = 128) -> torch.Tensor:
    """K10b: quantize a float32 (..., H, W) image to uint8 through K7's
    streaming pipeline, in segments of block_rows rows (any integer >= 1;
    it sets how finely the consumer warps' runs balance).  CUDA tensors go
    through csrc/copy_quantize.cu, CPU tensors take the plain version.  The
    output does not depend on block_rows."""
    _check_f32("copy quantize", v)
    bh = _block_rows(block_rows)
    if v.device.type == "cpu":
        return copy_quantize_reference(v)
    out, launched = _launch_on("vkr_copy_quantize_mono", v, bh)
    copy_quantize_mono.launches += launched
    if launched:
        copy_quantize_mono.staging = stream_form(v.shape[-1], v.data_ptr(), out.data_ptr())
    return out


copy_quantize_mono.launches = 0
copy_quantize_mono.staging = None


def copy_quantize_rows(v: torch.Tensor) -> torch.Tensor:
    """K10c: quantize a float32 (..., H, W) image to uint8 through the data
    movement of csrc/cas_rows.cu's kernel (K5, K3, K2).  CUDA tensors go
    through that kernel's copy-only instance, CPU tensors take the plain
    version."""
    _check_f32("copy quantize", v)
    if v.device.type == "cpu":
        return copy_quantize_reference(v)
    out, launched = _launch_on("vkr_copy_quantize_rows", v)
    copy_quantize_rows.launches += launched
    return out


copy_quantize_rows.launches = 0


def copy_quantize(v: torch.Tensor, form: str = "tile", block_rows: int = 128) -> torch.Tensor:
    """The copy-quantize probe in the data movement of K3's first design
    (form="tile", K10a), K7's (form="mono", K10b, block_rows rows per
    segment)
    or csrc/cas_rows.cu's kernel (form="rows", K10c)."""
    if form == "mono":
        return copy_quantize_mono(v, block_rows)
    if form in ("tile", "rows"):
        _block_rows(block_rows)
        return copy_quantize_tile(v) if form == "tile" else copy_quantize_rows(v)
    raise ValueError(f"form must be one of {FORMS}, got {form!r}")
