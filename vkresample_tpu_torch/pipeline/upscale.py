"""Single-image upscale pipeline: uint8 image in, uint8 planes or image out
(counterpart of vkresample_tpu/pipeline/upscale.py).

The port's slice is the reference's headline run: u=2, R2C spectrum, CAS
sharpen, in fp32 (-p 0) or half storage (-p 2), widths a multiple of 128,
every axis <= DENSE_MAX.  Per frame it runs

    dense.r2c_quad        x GEMM (odd columns) + y GEMM (odd rows)
    [HALF] Q2.14 staging  inside r2c_quad, the y GEMM reads stored planes
    cas_parity4_planes_u2 the hand-written quad CAS kernel (csrc/cas_quad.cu)

and returns four uint8 parity planes (C, h, w) that the PNG encoder weaves.
Every other plan raises NotImplementedError naming its ROADMAP.md item.

Numerics: every float32 GEMM runs in full fp32.  PyTorch's default already
keeps TF32 off for matmuls, but cuDNN's default is on; both are set off
explicitly when a pipeline is built (TF32 keeps ~3 decimal digits, which
would cost whole u8 LSBs through the y GEMM).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..core.config import Precision
from ..core.plan import DENSE_MAX, UpscalePlan
from ..fft import dense
from ..ops import cas as cas_ops
from ..ops.cas_cuda import cas_parity4_planes_u2


def _parity_route(plan: UpscalePlan) -> Optional[str]:
    """Which parity formulation the u=2 fast path uses: 'quad' (rows AND
    columns split: four planes) for 128-aligned widths or axes beyond the
    dense cap, 'rows' (two planes) otherwise, None when u != 2."""
    if plan.integer_upscale != 2:
        return None
    if plan.w % 128 == 0 or max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        return "quad"
    return "rows"


def unsupported_reason(plan: UpscalePlan) -> Optional[str]:
    """Why the port cannot run this plan yet (naming the ROADMAP.md item
    that ports it), or None when the plan is on the ported slice."""
    if plan.precision is Precision.DOUBLE:
        return "fp64 (-p 1) is not ported yet (ROADMAP.md modules item 6)"
    if not plan.r2c:
        return "the c2c spectrum path is not ported yet (ROADMAP.md modules item 6)"
    if plan.integer_upscale is None:
        return (
            f"fractional upscale {plan.upscale} is not ported yet "
            "(ROADMAP.md modules item 6)"
        )
    if plan.integer_upscale != 2:
        return (
            f"upscale factor {plan.integer_upscale} is not ported yet "
            "(ROADMAP.md modules item 6)"
        )
    if max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        return (
            f"axes over {DENSE_MAX} ({plan.h}x{plan.w} -> {plan.H}x{plan.W}) "
            "are not ported yet (ROADMAP.md modules item 8)"
        )
    if _parity_route(plan) != "quad" or not dense.r2c_rows_supported(plan):
        return (
            f"width {plan.w} is not a multiple of 128: the rows-parity route "
            "is not ported yet (ROADMAP.md modules item 5)"
        )
    return None


def parity_planes_supported(plan: UpscalePlan) -> bool:
    """True when the plan runs the fused per-parity CAS route whose native
    output is uint8 parity planes that the PNG encoder weaves."""
    return unsupported_reason(plan) is None


def planes_format(plan: UpscalePlan) -> Optional[str]:
    """Output layout of the planes_out pipeline: 'quad' = four (C, H/2,
    W/2) planes p[row parity][col parity]; None = not on the slice."""
    return "quad" if parity_planes_supported(plan) else None


def make_device_banks(plan: UpscalePlan, device) -> dict:
    """Float32 banks of the plan on `device` (built in f64 numpy)."""
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in dense.r2c_rows_banks(plan, "float32").items()
    }


def weave4(p00, p01, p10, p11) -> torch.Tensor:
    """Quad-parity uint8 planes (C, h, w) -> woven (2h, 2w, C) image, by a
    strided copy on the planes' device."""
    C, h, w = p00.shape
    out = torch.empty((2 * h, 2 * w, C), dtype=torch.uint8, device=p00.device)
    out[0::2, 0::2] = p00.permute(1, 2, 0)
    out[0::2, 1::2] = p01.permute(1, 2, 0)
    out[1::2, 0::2] = p10.permute(1, 2, 0)
    out[1::2, 1::2] = p11.permute(1, 2, 0)
    return out


def _pipeline(img_u8: torch.Tensor, banks: dict, plan: UpscalePlan,
              planes_out: bool):
    """(h, w, C) uint8 on the banks' device -> four (C, h, w) uint8 parity
    planes, or the woven (H, W, C) image when not planes_out."""
    # planar (C, h, w), like the reference
    x_raw = img_u8.permute(2, 0, 1).contiguous()
    codec = (
        dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
        if plan.precision is Precision.HALF
        else {}
    )
    Ps = dense.r2c_quad(x_raw, banks, **codec)
    Pu8 = cas_parity4_planes_u2(*Ps, plan.sharpen)
    return Pu8 if planes_out else weave4(*Pu8)


@functools.lru_cache(maxsize=16)
def _build(plan: UpscalePlan, device: torch.device, planes_out: bool) -> Callable:
    reason = unsupported_reason(plan)
    if reason is not None:
        raise NotImplementedError(reason)
    torch.backends.cuda.matmul.allow_tf32 = False  # see the module docstring
    torch.backends.cudnn.allow_tf32 = False
    banks = make_device_banks(plan, device)

    def fn(img):
        img = torch.as_tensor(img)
        if img.dtype != torch.uint8:
            raise TypeError(f"expected uint8 image, got {img.dtype}")
        if img.dim() == 2:
            img = img[:, :, None]
        if tuple(img.shape[:2]) != (plan.h, plan.w):
            raise ValueError(f"image {tuple(img.shape)} does not match plan {plan}")
        return _pipeline(img.to(device), banks, plan, planes_out)

    return fn


def build_upscale(plan: UpscalePlan, device=None, planes_out: bool = False) -> Callable:
    """Plan cache: the analog of initializeVulkanFFT called once per
    (shape, precision, upscale) and reused across frames
    (VkResample.cpp:1506-1508).  The f64-built banks are uploaded to
    `device` once here and reused by every call; the returned function maps
    an (h, w, C) uint8 image to four (C, h, w) uint8 parity planes
    (planes_out) or the woven (H, W, C) uint8 image, on `device`.

    device: a torch device (default: cuda when available, else cpu)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _build(plan, device, bool(planes_out))


def upscale(
    img,
    upscale: float,
    precision: Precision = Precision.SINGLE,
    sharpen: float = 0.2,
    r2c: bool = True,
    plan: Optional[UpscalePlan] = None,
    device=None,
) -> torch.Tensor:
    """Convenience entry: upscale one (h, w, C) uint8 image (numpy array or
    tensor).  Returns the (H, W, C) uint8 tensor on the device."""
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.dim() == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if plan is None:
        plan = UpscalePlan(
            h=h, w=w, upscale=upscale, precision=precision,
            sharpen=sharpen, r2c=r2c, channels=c,
        )
    return build_upscale(plan, device)(img)
