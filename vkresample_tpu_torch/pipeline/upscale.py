"""Upscale pipeline: uint8 image (or a batch of frames) in, uint8 planes or
image out (counterpart of vkresample_tpu/pipeline/upscale.py).

The port runs every plan the JAX package runs: R2C and c2c, with CAS
sharpen, in fp32 (-p 0), half storage (-p 2) or fp64 (-p 1), at any size,
on two engines.  The MXU engine (on this card: the GEMM forms of
fft/dense.py and fft/staged.py, bank choice in fft/mxu_pipeline.py) takes
one of these routes per frame, as the JAX package's _pipeline does:

  quad   r2c u=2, width % 128 == 0, parity-plane consumer (the CLI), every
         axis <= DENSE_MAX: dense.r2c_quad -> K1 cas_parity4_planes_u2 ->
         four uint8 planes
  rows   r2c u=2 otherwise below the cap, every woven caller included
         (upscale()): dense.r2c_rows -> K2 cas_parity_planes_u2 -> planes
         (E, D), woven on the device for woven callers
  rows   r2c integer u >= 3 below the cap: dense.r2c_rows -> K5
         cas_quantize_rows_u (row weave fused into the CAS) -> woven image
  chain  r2c fractional u and u=1 below the cap: dense.r2c_chain on the
         normalized image -> K3 cas_quantize
  staged quad   r2c u=2 above the cap, any even width:
         staged.r2c_quad_staged -> K1 -> four uint8 planes, woven on the
         device (weave_grid_u8) for woven callers
  big grid      r2c integer u >= 3 or a fraction p/q above the cap:
         staged.r2c_grid_staged -> p^2 phase planes -> K4
         cas_parity_grid_planes -> p^2 uint8 planes, woven for woven callers
  grid   c2c with p <= 4 phases below the cap, any p above it (integer
         u >= 2 or a fraction p/q): staged.c2c_grid_staged -> p^2 magnitude
         planes -> K1 at p=2, K4 at p >= 3 -> p^2 uint8 planes
  chain  c2c otherwise (u=1, p > 4 below the cap): dense.c2c_chain -> K3

Above GRID_MAX_U = 8 phases the grid planes are woven and take K3 (K4's
instances stop at 8).  In half storage the pre-CAS planes are int16 Q2.14
and the y convolutions read the stored planes; the chains keep float32 (the
JAX generic branch has no storage codec).  The XLA engine (-engine xla, the
reference tier) runs torch.fft on the materialized big spectrum -> K3, at
any size.  An MXU plan above the cap that no staged form takes raises
JAX's ValueError when its factor is a fraction and runs the reference tier
when it is an integer (the JAX package runs its mixed-radix phases route
there; fft/mxu_pipeline.py).

fp64 (-p 1) runs no kernel, as the JAX package keeps it off Pallas: the
image is normalized in float64, the pre-CAS image comes from the float64
staged banks (fft/mxu_pipeline.py: staged64, grid64, c2cgrid64), the dense
float64 banks where no staged form applies, or torch.fft in float64 on the
XLA engine, and ops/cas.py::cas_quantize_banded sharpens and quantizes it
in row bands, so the peak memory stays a few GB at any size.  -p 1 has no
parity-plane output: its callers get the woven image.

Every route takes leading frame dims: N frames in one call run each GEMM
once on the batch and each CAS kernel once on N*C planes
(pipeline/batched.py).  Frames with more than CHANNEL_SERIAL_ELEMS output
elements (C*H*W) run one channel at a time, as the JAX package's
channel-serial loop does, with the same output.

The route also depends on the card: a card with a row in core/tuning.py
sets the cap between the dense and the staged tiers for the plan families
its sweep times (fft/mxu_pipeline.py::card_cap_applies; UpscalePlan.
dense_max, filled by the entry points).

Every entry point runs on the current CUDA device unless the caller names
another (``device="cpu"`` runs the kernels' plain versions); without a
CUDA device and without that request it raises RuntimeError.

Numerics: every float32 GEMM runs in full fp32 (the JAX package pins a
precision per matmul, core/config.py::Precision.matmul_precision); TF32
keeps a 10-bit mantissa, which the <= 1 LSB bar against the fp64 oracle
does not budget for.  Each call of a built pipeline runs inside
core/config.py::fp32_matmul(): the matmul and cuDNN TF32 settings are
pinned to full fp32 for the call and the caller's own settings are
restored when it returns or raises.  The flags are read when each op is
dispatched on the host, so the asynchronous launches of the call see fp32
too; building a pipeline changes no setting.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Engine, Precision, fp32_matmul, resolve_device
from ..core.plan import UpscalePlan
from ..core.tuning import plan_for
from ..fft import dense, mxu_pipeline, staged
from ..ops import cas as cas_ops
from ..ops.cas_cuda import (
    GRID_MAX_U,
    cas_parity4_planes_u2,
    cas_parity_grid_planes,
    cas_parity_planes_u2,
    cas_quantize,
    cas_quantize_rows_u,
)
from ..ops.spectrum import assemble_big_spectrum
from ..ops.weave import weave_grid, weave_grid_u8, weave_rows_u8


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
    dense cap (mxu_pipeline.above_cap), 'rows' (two planes) otherwise, None
    when u != 2."""
    if plan.integer_upscale != 2:
        return None
    if plan.w % 128 == 0 or mxu_pipeline.above_cap(plan):
        return "quad"
    return "rows"


def route_engine(plan: UpscalePlan) -> Engine:
    """The engine the plan runs on: plan.resolve_engine(), except that an
    MXU plan with no bank set runs the reference tier when its factor is
    an integer and raises JAX's ValueError when it is a fraction."""
    engine = plan.resolve_engine()
    if engine is Engine.MXU and mxu_pipeline.bank_set(plan) is None:
        if plan.integer_upscale is None:
            raise mxu_pipeline.big_fraction_error(plan)
        return Engine.XLA
    return engine


def planes_format(plan: UpscalePlan) -> Optional[str]:
    """Output layout of the planes_out pipeline: 'quad' = four (C, H/2,
    W/2) planes p[row parity][col parity]; 'rows' = (E, D), each (C, H/2,
    W), the even and odd output rows; 'grid' = p^2 (C, H/p, W/p) planes
    row-major (ry, rx) (the c2c grid, p=2 included, and the r2c big grid);
    None = woven output only (-p 1 among them)."""
    if plan.precision is Precision.DOUBLE or plan.resolve_engine() is not Engine.MXU:
        return None
    tag = mxu_pipeline.bank_set(plan)
    if tag in ("c2cgrid", "grid"):
        return "grid"
    if tag == "staged":
        return "quad"
    if tag == "rows":
        return _parity_route(plan)
    return None


def parity_planes_supported(plan: UpscalePlan) -> bool:
    """True when the plan runs a fused per-parity CAS route whose native
    output is uint8 parity planes that the PNG encoder weaves."""
    return planes_format(plan) is not None


def make_device_banks(plan: UpscalePlan, engine: Engine, device, planes_out: bool):
    """The banks of an MXU plan on `device` (built in f64 numpy, through
    the disk bank cache), None for the XLA engine and for plans with no
    bank set.  Of the row-split banks only the x bank the route reads is
    uploaded: alpha_odd for the quad route, alpha otherwise."""
    if engine is not Engine.MXU:
        return None
    banks = mxu_pipeline.make_dense_banks(plan)
    if banks is None:
        return None
    unused = "alpha" if planes_out and planes_format(plan) == "quad" else "alpha_odd"
    return {k: torch.from_numpy(v).to(device) for k, v in banks.items() if k != unused}


# output elements (C*H*W) above which a frame runs one channel at a time
# (vkresample_tpu/pipeline/upscale.py CHANNEL_SERIAL_ELEMS): a 3-channel
# 16K -> 32K frame (1.6e9) still runs batched
CHANNEL_SERIAL_ELEMS = int(2e9)


def _channel_serial(plan: UpscalePlan, img_u8: torch.Tensor) -> bool:
    c = img_u8.shape[-1]
    return c > 1 and plan.H * plan.W * c > CHANNEL_SERIAL_ELEMS


def _grid_cas(Ps, u: int, sharpen: float):
    """The fused per-parity CAS of p^2 = u*u grid planes: K1 at u=2, K4 up
    to GRID_MAX_U, beyond that the planes woven and K3, split back."""
    if u == 2:
        return cas_parity4_planes_u2(*Ps, sharpen)
    if u <= GRID_MAX_U:
        return cas_parity_grid_planes(Ps, u, sharpen)
    out = cas_quantize(weave_grid(Ps, u), sharpen)
    return tuple(out[..., ry::u, rx::u].contiguous() for ry in range(u) for rx in range(u))


def _pipeline(img_u8: torch.Tensor, banks, plan: UpscalePlan, engine: Engine,
              planes_out: bool, planar_out: bool):
    """(..., h, w, C) uint8 on the device -> the parity planes of
    planes_format(plan) (planes_out), or the woven (..., H, W, C) uint8
    image ((..., C, H, W) when planar_out).  Leading dims are frames: every
    transform broadcasts over them and every CAS kernel folds them into its
    plane count, so a batch of N frames runs each kernel once."""
    if _channel_serial(plan, img_u8):
        # one channel's working set live at a time; the outputs are
        # concatenated on the channel axis (the reference loops its
        # coordinates on the device the same way, vkFFT.h:7640-7646)
        outs = [_pipeline(img_u8[..., c:c + 1], banks, plan, engine, planes_out, True)
                for c in range(img_u8.shape[-1])]
        if planes_out:
            return tuple(torch.cat(ps, dim=-3) for ps in zip(*outs))
        out = torch.cat(outs, dim=-3)
        return out if planar_out else out.movedim(-3, -1).contiguous()
    x_raw = img_u8.movedim(-1, -3).contiguous()  # planar (..., C, h, w), like the reference
    codec = (
        dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
        if plan.precision is Precision.HALF
        else {}
    )
    if plan.precision is Precision.DOUBLE:
        # no kernel: the float64 pre-CAS image, then the banded CAS
        x = cas_ops.normalize_u8(x_raw, torch.float64)
        out = cas_ops.cas_quantize_banded(_precas(x, plan, engine, banks), plan.sharpen)
    elif banks is not None and ("cg_ay" in banks or "stx_b1" in banks or "sgx1_b1" in banks):
        # the staged forms: raw uint8 feeds the convolutions (/255 folded
        # into the x banks); the parity or phase planes go to the fused
        # per-parity CAS
        if "cg_ay" in banks:
            u, Ps = staged.c2c_grid_u(banks), staged.c2c_grid_staged(x_raw, banks, **codec)
        elif "stx_b1" in banks:
            u, Ps = 2, staged.r2c_quad_staged(x_raw, banks, **codec)
        else:
            u, Ps = staged.grid_u(banks), staged.r2c_grid_staged(x_raw, banks, **codec)
        Pu8 = _grid_cas(Ps, u, plan.sharpen)
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
    return out if planar_out else out.movedim(-3, -1).contiguous()


# the CAS kernels launch one block row per plane on grid.z (csrc/cas_grid.cu,
# csrc/cas_rows.cu), so frames x channels of one call may not pass this
MAX_PLANES = 65535


@functools.lru_cache(maxsize=16)
def _build(plan: UpscalePlan, device: torch.device, planes_out: bool,
           planar_out: bool) -> Callable:
    if planes_out and planes_format(plan) is None:
        raise ValueError(f"the plan has no parity-plane output: {plan}")
    engine = route_engine(plan)
    banks = make_device_banks(plan, engine, device, planes_out)

    def fn(img):
        with fp32_matmul():  # see the module docstring
            img = torch.as_tensor(img)
            if img.dtype != torch.uint8:
                raise TypeError(f"expected uint8 image, got {img.dtype}")
            if img.dim() == 2:
                img = img[:, :, None]
            if img.dim() < 3 or tuple(img.shape[-3:-1]) != (plan.h, plan.w):
                raise ValueError(f"image {tuple(img.shape)} does not match plan {plan}")
            planes = img[..., 0, 0, :].numel()
            if planes > MAX_PLANES:
                raise ValueError(
                    f"{planes} planes (frames x channels) in one call; the CAS kernels "
                    f"take at most {MAX_PLANES} ({MAX_PLANES // img.shape[-1]} frames "
                    f"of {img.shape[-1]} channels)")
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
    `device`.  It also takes leading frame dims, (..., h, w, C) ->
    (..., C, H/2, W/2) quad planes and so on (pipeline/batched.py), up to
    MAX_PLANES frames x channels a call.

    device: a torch device (default: the current CUDA device; RuntimeError
    when there is none; "cpu" runs the kernels' plain versions).  The plan
    takes the device's dense cap (core/tuning.py::plan_for) unless it has
    one."""
    device = resolve_device(device)
    return _build(plan_for(plan, device), device, bool(planes_out), bool(planar_out))


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
