"""Single-image upscale pipeline: uint8 image in, uint8 planes or image out
(counterpart of vkresample_tpu/pipeline/upscale.py).

The port runs the small dense tier (every axis <= DENSE_MAX) with CAS
sharpen, R2C and c2c, in fp32 (-p 0) or half storage (-p 2), on two
engines.  The MXU engine (on this card: the GEMM forms of fft/dense.py and
fft/staged.py, fft/mxu_pipeline.py) takes one of these routes per frame,
as the JAX package's _pipeline does:

  quad   r2c u=2, width % 128 == 0, parity-plane consumer (the CLI):
         dense.r2c_quad -> K1 cas_parity4_planes_u2 -> four uint8 planes
  rows   r2c u=2 otherwise, every woven caller included (upscale()):
         dense.r2c_rows -> K2 cas_parity_planes_u2 -> planes (E, D), woven
         on the device for woven callers
  rows   r2c integer u >= 3: dense.r2c_rows -> K5 cas_quantize_rows_u (row
         weave fused into the CAS) -> woven image
  chain  r2c fractional u and u=1: dense.r2c_chain on the normalized image
         -> K3 cas_quantize
  grid   c2c with p <= 4 phases (integer u >= 2 or a fraction p/q):
         staged.c2c_grid_staged -> p^2 magnitude planes -> K1 at p=2, K4
         cas_parity_grid_planes at p >= 3 -> p^2 uint8 planes, woven on the
         device for woven callers
  chain  c2c otherwise (u=1, p > 4): dense.c2c_chain -> K3 cas_quantize

In half storage the pre-CAS planes are int16 Q2.14 and the y GEMMs read
the stored planes; the chains keep float32 (the JAX generic branch has no
storage codec).  The XLA engine (-engine xla, the reference tier) runs
torch.fft on the materialized big spectrum -> K3.  fp64 and axes over
DENSE_MAX raise NotImplementedError naming their ROADMAP.md item.

Every entry point runs on the current CUDA device unless the caller names
another (``device="cpu"`` runs the kernels' plain versions); without a
CUDA device and without that request it raises RuntimeError.

Numerics: every float32 GEMM runs in full fp32 (the JAX package pins a
precision per matmul, core/config.py::Precision.matmul_precision); TF32
keeps a 10-bit mantissa, which the <= 1 LSB bar against the fp64 oracle
does not budget for.  Each call of a built pipeline runs inside
fp32_matmul(): the matmul and cuDNN TF32 settings are pinned to full fp32
for the call and the caller's own settings are restored when it returns or
raises.  The flags are read when
each op is dispatched on the host, so the asynchronous launches of the
call see fp32 too; building a pipeline changes no setting.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Engine, Precision, resolve_device
from ..core.plan import DENSE_MAX, UpscalePlan
from ..fft import dense, mxu_pipeline, staged
from ..ops import cas as cas_ops
from ..ops.cas_cuda import (
    cas_parity4_planes_u2,
    cas_parity_grid_planes,
    cas_parity_planes_u2,
    cas_quantize,
    cas_quantize_rows_u,
)
from ..ops.spectrum import assemble_big_spectrum
from ..ops.weave import weave_grid_u8, weave_rows_u8


@contextlib.contextmanager
def fp32_matmul():
    """Run the block with float32 matmuls (and cuDNN convolutions and RNNs)
    in full fp32, then restore the TF32 settings exactly as they were, also
    when the block raises.  torch.set_float32_matmul_precision sets the
    legacy matmul precision and the per-backend matmul fp32_precision
    together; cuDNN goes through its per-backend fp32_precision settings
    where the installed torch has them, else through cudnn.allow_tf32."""
    b = torch.backends
    if hasattr(b.cuda.matmul, "fp32_precision"):
        flags = [(m, "fp32_precision", "ieee") for m in (b.cuda.matmul, b.cudnn.conv, b.cudnn.rnn)]
    else:
        flags = [(b.cudnn, "allow_tf32", False)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in flags]
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    for m, name, value in flags:
        setattr(m, name, value)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        for m, name, value in saved:
            setattr(m, name, value)


def _irfft2(G: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Inverse of a (..., H, W//2+1) half spectrum to (..., H, W) real,
    normalized by 1/(H*W).  The y pass is a complex inverse; the x pass a
    C2R that drops the imaginary parts of the DC and Nyquist columns, as
    numpy's irfft and the reference's C2R do: they are zeroed explicitly
    so the result does not rest on how cuFFT treats a non-Hermitian C2R
    input (the relocated y-Nyquist row makes column 0 non-Hermitian)."""
    g = torch.fft.ifft(G, n=H, dim=-2)
    g[..., 0].imag.zero_()
    if W % 2 == 0:
        g[..., W // 2].imag.zero_()
    return torch.fft.irfft(g, n=W, dim=-1)


def _precas_xla(x: torch.Tensor, plan: UpscalePlan) -> torch.Tensor:
    """(..., h, w) normalized image -> (..., H, W) pre-CAS image in CAS
    units: the reference tier, torch.fft on the materialized big spectrum
    with the u^2 factor taken in float32 (upscale.py:28-41).  c2c takes
    the complex magnitude, which CAS consumes (VkResample.cpp:904)."""
    u2 = float(np.float32(float(np.float32(plan.upscale)) ** 2))
    if not plan.r2c:
        G = assemble_big_spectrum(torch.fft.fft2(x), plan)
        return u2 * torch.abs(torch.fft.ifft2(G))
    G = assemble_big_spectrum(torch.fft.rfft2(x), plan)
    return u2 * _irfft2(G, plan.H, plan.W)


def _precas(x: torch.Tensor, plan: UpscalePlan, engine: Engine, banks) -> torch.Tensor:
    if engine is Engine.XLA:
        return _precas_xla(x, plan)
    return mxu_pipeline.upscale_precas_mxu(x, plan, banks)


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
    that ports it), or None when the plan is on the ported tiers."""
    if plan.precision is Precision.DOUBLE:
        return "fp64 (-p 1) is not ported yet (ROADMAP.md modules item 2)"
    if max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        return (
            f"axes over {DENSE_MAX} ({plan.h}x{plan.w} -> {plan.H}x{plan.W}) "
            "are not ported yet (ROADMAP.md modules item 5)"
        )
    return None


def planes_format(plan: UpscalePlan) -> Optional[str]:
    """Output layout of the planes_out pipeline: 'quad' = four (C, H/2,
    W/2) planes p[row parity][col parity]; 'rows' = (E, D), each (C, H/2,
    W), the even and odd output rows; 'grid' = p^2 (C, H/p, W/p) planes
    row-major (ry, rx) (c2c grid route, p=2 included); None = woven output
    only."""
    if unsupported_reason(plan) is not None or plan.resolve_engine() is not Engine.MXU:
        return None
    if not plan.r2c:
        return "grid" if mxu_pipeline.c2c_grid_selected(plan) else None
    return _parity_route(plan)


def parity_planes_supported(plan: UpscalePlan) -> bool:
    """True when the plan runs a fused per-parity CAS route whose native
    output is uint8 parity planes that the PNG encoder weaves."""
    return planes_format(plan) is not None


def make_device_banks(plan: UpscalePlan, engine: Engine, device, planes_out: bool):
    """Float32 dense banks of an MXU plan on `device` (built in f64 numpy),
    None for the XLA engine.  Only the x bank the route reads is uploaded:
    alpha_odd for the quad route, alpha otherwise."""
    if engine is not Engine.MXU:
        return None
    unused = "alpha" if planes_out and planes_format(plan) == "quad" else "alpha_odd"
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in mxu_pipeline.make_dense_banks(plan, "float32").items()
        if k != unused
    }


def _pipeline(img_u8: torch.Tensor, banks, plan: UpscalePlan, engine: Engine,
              planes_out: bool, planar_out: bool):
    """(h, w, C) uint8 on the device -> the parity planes of
    planes_format(plan) (planes_out), or the woven (H, W, C) uint8 image
    ((C, H, W) when planar_out)."""
    x_raw = img_u8.permute(2, 0, 1).contiguous()  # planar (C, h, w), like the reference
    codec = (
        dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
        if plan.precision is Precision.HALF
        else {}
    )
    if banks is not None and "cg_ay" in banks:
        # c2c grid: raw uint8 feeds the staged convolutions (/255 folded
        # into the x banks); the p^2 magnitude planes go to the fused
        # per-parity CAS
        u = staged.c2c_grid_u(banks)
        Ps = staged.c2c_grid_staged(x_raw, banks, **codec)
        if u == 2:
            Pu8 = cas_parity4_planes_u2(*Ps, plan.sharpen)
        else:
            Pu8 = cas_parity_grid_planes(Ps, u, plan.sharpen)
        if planes_out:
            return Pu8
        out = weave_grid_u8(Pu8, u)
    elif banks is not None and "Ymat_ns" in banks:
        # row-split fast paths: raw uint8 feeds the x GEMM (/255 folded
        # into the banks), the y GEMM emits the non-sample rows
        fmt = _parity_route(plan)
        if fmt == "quad" and planes_out:
            return cas_parity4_planes_u2(*dense.r2c_quad(x_raw, banks, **codec), plan.sharpen)
        U, O = dense.r2c_rows(x_raw, banks, **codec)
        if fmt is not None:
            E, D = cas_parity_planes_u2(U, O, plan.sharpen)
            if planes_out:
                return E, D
            out = weave_rows_u8(E, D)
        else:
            out = cas_quantize_rows_u(U, O, plan.integer_upscale, plan.sharpen)
    else:
        x = cas_ops.normalize_u8(x_raw)
        out = cas_quantize(_precas(x, plan, engine, banks), plan.sharpen)
    return out if planar_out else out.permute(1, 2, 0).contiguous()


@functools.lru_cache(maxsize=16)
def _build(plan: UpscalePlan, device: torch.device, planes_out: bool,
           planar_out: bool) -> Callable:
    reason = unsupported_reason(plan)
    if reason is not None:
        raise NotImplementedError(reason)
    if planes_out and planes_format(plan) is None:
        raise ValueError(f"the plan has no parity-plane output: {plan}")
    engine = plan.resolve_engine()
    banks = make_device_banks(plan, engine, device, planes_out)

    def fn(img):
        with fp32_matmul():  # see the module docstring
            img = torch.as_tensor(img)
            if img.dtype != torch.uint8:
                raise TypeError(f"expected uint8 image, got {img.dtype}")
            if img.dim() == 2:
                img = img[:, :, None]
            if tuple(img.shape[:2]) != (plan.h, plan.w):
                raise ValueError(f"image {tuple(img.shape)} does not match plan {plan}")
            return _pipeline(img.to(device), banks, plan, engine, planes_out, planar_out)

    return fn


def build_upscale(plan: UpscalePlan, device=None, planes_out: bool = False,
                  planar_out: bool = False) -> Callable:
    """Plan cache: the analog of initializeVulkanFFT called once per
    (shape, precision, upscale) and reused across frames
    (VkResample.cpp:1506-1508).  The f64-built banks are uploaded to
    `device` once here and reused by every call.  The returned function
    maps an (h, w, C) uint8 image to the uint8 parity planes of
    planes_format(plan) (planes_out; ValueError when the plan has none), or
    to the woven (H, W, C) uint8 image ((C, H, W) when planar_out), on
    `device`.

    device: a torch device (default: the current CUDA device; RuntimeError
    when there is none; "cpu" runs the kernels' plain versions)."""
    return _build(plan, resolve_device(device), bool(planes_out), bool(planar_out))


def upscale(
    img,
    upscale: float,
    precision: Precision = Precision.SINGLE,
    sharpen: float = 0.2,
    r2c: bool = True,
    engine: Engine = Engine.AUTO,
    plan: Optional[UpscalePlan] = None,
    device=None,
) -> torch.Tensor:
    """Convenience entry: upscale one (h, w, C) uint8 image (numpy array or
    tensor).  Returns the (H, W, C) uint8 tensor on the device (default:
    the current CUDA device, see build_upscale)."""
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.dim() == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if plan is None:
        plan = UpscalePlan(
            h=h, w=w, upscale=upscale, precision=precision,
            sharpen=sharpen, r2c=r2c, channels=c, engine=engine,
        )
    return build_upscale(plan, device)(img)
