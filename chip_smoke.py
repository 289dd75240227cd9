"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's routes (vkresample_tpu_torch: R2C and c2c upscale with
CAS sharpen, half storage -p 2 and fp32 -p 0) on the card at full frame
sizes, and fails (non-zero exit, no result line) unless every phase passes:

  1. device   a CUDA device is present; prints its name and power limit
  2. build    builds the CUDA kernels from vkresample_tpu_torch/csrc/
  3. kernels  each kernel against its plain PyTorch version on seeded
              inputs at its routes' shapes and small odd ones, int16 and
              f32 (<= 1 u8 LSB, >= 99.9 % of pixels identical); K4 at
              its route shapes (u = 3: 9 x (3, 720, 1280), 9 x (3, 360,
              640); u = 4: 16 x (3, 540, 960)) and at every u = 1..8 with h
              and W off its band and strip edges, W % 4 != 0, single rows
              or columns and planes 2 or 4 bytes off alignment, identical on
              every pixel to its plain version; K1 (K4's U = 2 instance) at
              its route shape 4 x (3, 1024, 2048) and at the same kinds of
              edge cases, misaligned planes among them, identical on every
              pixel to its plain version; K3 (K5's kernel at u = 1) at its
              route shape (3, 2160, 3840) and at K5's edge set at u = 1,
              a misaligned image among them, identical on every pixel to
              its plain version; K2 (K5's kernel at u = 2 with a parity
              store) at its route shapes, the rows route's 2 x (3, 1080,
              2880) and the woven flagship's 2 x (3, 1024, 4096), and at
              K5's edge set at u = 2, misaligned U and O among them,
              identical on every pixel to its plain version; K5 at its
              route shapes (u = 3: U
              (3, 720, 3840) + O (3, 1440, 3840); u = 4: U (3, 540, 3840) +
              O (3, 1620, 3840)) and at u = 2..8 and 11 with u*h and W off
              its band and strip edges, W % 4 != 0, single rows or columns
              and U and O 2 or 4 bytes off alignment, identical on every
              pixel to its plain version and to weave_rows + K3; K8 and K9
              at both fused-y frames with the frame's y bank and at odd
              shapes (h = 1, 37; W = 200) with T2 present and absent; K6
              and K7 (f32 only) at the A/B frame's (3, 2048, 4096), K3's
              (3, 2160, 3840) and (2, 37, 201) at bh 1, 7, 64 (K6) and 1,
              32, 128 (K7): K7 identical to its plain version and to K3
              on every pixel, K6 within 1 LSB of K3; the copy-quantize
              probes K10a (the tile of K3's first design), K10b (K7's
              band pipeline) and K10c (the copy-only instance of
              cas_rows.cu's kernel, K5's, K3's and K2's data movement),
              f32 only, at (3, 2048, 4096), (3, 2160, 3840) and (2, 37,
              201), K10b at bh 128, 64, 32 and 1, K10c also at odd and
              misaligned images, identical on every pixel to their plain
              version
  4. routes   each route through the entry point a user calls
              (build_upscale(plan, planes_out=True) as the CLI does, or
              upscale()) against the fp64 oracle (<= 1 LSB); every
              kernel's launch counter is set to 0 just before each route
              and read just after, and must be > 0 exactly for the
              route's kernels:
                quad     2048x1024 -> 4096x2048 u=2, -p 2 and -p 0    K1
                rows     1440x1080 -> 2880x2160 u=2, -p 2 and -p 0    K2
                woven    upscale() 2048x1024 -> 4096x2048, -p 2       K2
                u=3      1280x720 -> 3840x2160, -p 2 and -p 0         K5
                u=4      960x540 -> 3840x2160, -p 2                   K5
                chain    1280x720 -> 1920x1080 at 1.5x, -p 0          K3
                xla      -engine xla 1920x1080 -> 3840x2160, -p 0     K3
                c2c grid u=2  2048x1024 -> 4096x2048, -p 2           K1
                c2c grid u=3  1280x720 -> 3840x2160, -p 2 and -p 0   K4
                c2c grid u=4  960x540 -> 3840x2160, -p 2             K4
                c2c grid 1.5x 1280x720 -> 1920x1080, -p 2            K4
                c2c woven upscale() u=3 1280x720, -p 2               K4
                c2c chain 2.5x 1280x720 -> 3200x1800, -p 0           K3
                xla c2c  -engine xla 1920x1080 -> 3840x2160, -p 0    K3
              and prints which staging form (16-byte or per element) each
              route's K1, K2 or K3 call took; then the fused-y runs, the rows
              route's x pass
              (dense.r2c_x_only) followed by a fused y-GEMM + CAS kernel,
              against the oracle (<= 1 LSB) and the rows route's output
              (<= 1 LSB; >= 99.9 % identical in -p 0, >= 99.5 % in -p 2,
              where the route rounds O to Q2.14 and the fused kernel does
              not), same counter rule:
                fused y  1440x1080 -> 2880x2160, -p 2 and -p 0        K8
                fused y  2048x1024 -> 4096x2048, -p 2                 K9
              then the woven-CAS A/B runs, the JAX A/B scripts' frame
              (scripts/cas_blocked_ab.py, cas_mono_ab.py): 2048x1024 ->
              4096x2048 u=2 -p 2 plan, dense.r2c_rows without a codec,
              dense.weave_rows (f32), one CAS, against the oracle (<= 1
              LSB), same counter rule:
                cas ab K3, K6 bh=64/128/256, K7 bh=64/128             K3/K6/K7
              then the CAS-split runs, the JAX script's frame
              (scripts/cas_split.py): the A/B frame's woven image, then a
              copy-quantize probe, identical on every pixel to the plain
              quantize_u8 of the same woven image on the card, same
              counter rule:
                cas split K10a, K10b bh=64/128, K10c                  K10a/K10b/K10c
              and the TF32 check: under the caller's
              torch.set_float32_matmul_precision("high") the cached quad -p 0
              function stays <= 1 LSB from the oracle (its GEMMs run in
              fp32) and the caller's setting is left as it was; the same
              frame run without the pin is printed beside it
  5. CLI      python -m vkresample_tpu_torch on the samples (-validate),
              the 256x128 sample at u=2 and u=1.5 against its golden PNGs
              (<= 1 LSB), a frame whose width is not a multiple of 128,
              and -c2c at u=2 (1920x1080 sample) and u=3 (600x400 frame)
  6. times    ms/frame of every route, fused-y, A/B and CAS-split run
              (-n 20, CUDA events), each kernel against its plain version
              (50 wrapper calls, CUDA events; K4 at its three route shapes
              and K2 and K5 at their two, and beside them, printed only,
              the device time alone of K1, K2, K3, K4 and K5: 50 calls
              replayed from one CUDA graph, since K4's wrapper takes about
              as long on the host as its kernel on the device), the
              unfused forms K5, K8
              and K9 replace (weave_rows + K3; torch.matmul y GEMM, Q2.14
              store in -p 2, + K2, woven for K9),
              K3 beside K6 and K7 at their shape, K10c beside K3 and K10b
              beside K7 (bh 128 and 64) at (3, 2048, 4096), and the device
              grid weave

The line before the card's line lists each kernel with its launches over
the routes and runs, its worst difference, its time, its plain version's
time and its bound: the larger of the bytes it must move (inputs read
once, outputs written once; K6's halo rows included) over 3.35 TB/s and
its fp32 operations (~40 per output pixel
for the CAS, 3 for the quantize, plus 2*C*h*(h+r)*W for the fused y GEMM)
over 67 TFLOP/s (H100 SXM).  No single PyTorch call computes CAS, with or
without the GEMM, or the truncating uint8 quantize, so library_ms is null.
It imports nothing of JAX.  The last stdout line is
the result JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
TOL_LSB = 1
MIN_IDENTICAL = 0.999
MIN_IDENTICAL_VS_Q214_ROUTE = 0.995  # fused y vs the -p 2 rows route (O Q2.14 there)
C = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
CAS_OPS_PER_PIXEL = 40  # cas_common.cuh: clip, min/max tree, blend, quantize
QUANT_OPS_PER_PIXEL = 3  # cas_common.cuh::quantize_u8: multiply, two clamps

# route name -> ((h, w), upscale, precision, engine, r2c, entry, kernels it runs)
ROUTES = {
    "quad -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", True, "planes", {"K1"}),
    "quad -p 0": ((1024, 2048), 2.0, "SINGLE", "AUTO", True, "planes", {"K1"}),
    "rows -p 2": ((1080, 1440), 2.0, "HALF", "AUTO", True, "planes", {"K2"}),
    "rows -p 0": ((1080, 1440), 2.0, "SINGLE", "AUTO", True, "planes", {"K2"}),
    "woven upscale() -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", True, "woven", {"K2"}),
    "u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", True, "woven", {"K5"}),
    "u=3 -p 0": ((720, 1280), 3.0, "SINGLE", "AUTO", True, "woven", {"K5"}),
    "u=4 -p 2": ((540, 960), 4.0, "HALF", "AUTO", True, "woven", {"K5"}),
    "chain 1.5x -p 0": ((720, 1280), 1.5, "SINGLE", "AUTO", True, "woven", {"K3"}),
    "xla -p 0": ((1080, 1920), 2.0, "SINGLE", "XLA", True, "woven", {"K3"}),
    "c2c grid u=2 -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", False, "planes", {"K1"}),
    "c2c grid u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", False, "planes", {"K4"}),
    "c2c grid u=3 -p 0": ((720, 1280), 3.0, "SINGLE", "AUTO", False, "planes", {"K4"}),
    "c2c grid u=4 -p 2": ((540, 960), 4.0, "HALF", "AUTO", False, "planes", {"K4"}),
    "c2c grid 1.5x -p 2": ((720, 1280), 1.5, "HALF", "AUTO", False, "planes", {"K4"}),
    "c2c woven upscale() u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", False, "woven", {"K4"}),
    "c2c chain 2.5x -p 0": ((720, 1280), 2.5, "SINGLE", "AUTO", False, "woven", {"K3"}),
    "xla c2c -p 0": ((1080, 1920), 2.0, "SINGLE", "XLA", False, "woven", {"K3"}),
}

# fused-y run -> ((h, w), precision, its kernel, the u=2 route it is held against)
FUSED = {
    "fused y K8 -p 2": ((1080, 1440), "HALF", "K8", "rows -p 2"),
    "fused y K8 -p 0": ((1080, 1440), "SINGLE", "K8", "rows -p 0"),
    "fused y K9 -p 2": ((1024, 2048), "HALF", "K9", "woven upscale() -p 2"),
}

# woven-CAS A/B run -> (its kernel, rows per block or band); the frame is
# CAS_AB_FRAME (h, w) at u=2 with a -p 2 plan, as in the JAX A/B scripts
CAS_AB_FRAME = (1024, 2048)
CAS_AB = {
    "cas ab K3": ("K3", None),
    "cas ab K6 bh=64": ("K6", 64),
    "cas ab K6 bh=128": ("K6", 128),
    "cas ab K6 bh=256": ("K6", 256),
    "cas ab K7 bh=64": ("K7", 64),
    "cas ab K7 bh=128": ("K7", 128),
}

# CAS-split run -> (its copy-quantize probe, rows per band); the frame is the
# A/B frame, as in the JAX script scripts/cas_split.py
CAS_SPLIT = {
    "cas split K10a": ("K10a", None),
    "cas split K10b bh=64": ("K10b", 64),
    "cas split K10b bh=128": ("K10b", 128),
    "cas split K10c": ("K10c", None),
}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int) -> float:
    """ms per call of fn on the device alone: n calls captured in one CUDA
    graph and replayed, so the wrapper's host work (checks, output
    allocations, the ctypes call) is not in the reading."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def u8_diff(got, want):
    """(max |diff|, share identical) over matching uint8 tensors/arrays."""
    import numpy as np

    g = [np.asarray(x.cpu() if hasattr(x, "cpu") else x).astype(np.int16) for x in got]
    w = [np.asarray(x.cpu() if hasattr(x, "cpu") else x).astype(np.int16) for x in want]
    d = max(int(np.abs(a - b).max()) for a, b in zip(g, w))
    same = sum(int((a == b).sum()) for a, b in zip(g, w)) / sum(a.size for a in g)
    return d, same


def woven_hwc(out, fmt, plan):
    """A route's output as the (H, W, C) uint8 host image."""
    import numpy as np

    from vkresample_tpu_torch.io.png import weave4_host, weave_grid_host

    if fmt == "quad":
        return np.moveaxis(weave4_host(*[p.cpu().numpy() for p in out]), 0, -1)
    if fmt == "grid":
        planes = [p.cpu().numpy() for p in out]
        return np.moveaxis(weave_grid_host(planes, int(round(len(planes) ** 0.5))), 0, -1)
    if fmt == "rows":
        e, d = (p.cpu().numpy() for p in out)
        return np.moveaxis(np.stack([e, d], axis=2).reshape(C, plan.H, plan.W), 0, -1)
    if fmt == "planar":
        return np.moveaxis(out.cpu().numpy(), 0, -1)
    return out.cpu().numpy()


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the fp32 operations over the fp32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cas_bound(shape, n_planes: int, in_bytes: int):
    """Bound of a CAS kernel on n_planes input planes of `shape` giving as
    many uint8 pixels."""
    px = n_planes
    for d in shape:
        px *= d
    return bound(px * (in_bytes + 1), px * CAS_OPS_PER_PIXEL)


def ycas_bound(U, T2, YT):
    """Bound of a fused y-GEMM + CAS kernel: U, T2 and YT read once, 2*C*h*W
    uint8 written; the y GEMM's 2*C*h*(h+r)*W operations plus the CAS."""
    h, K = YT.shape
    chw = U.numel()
    n_bytes = (chw * U.element_size() + (0 if T2 is None else T2.numel() * 4)
               + YT.numel() * 4 + 2 * chw)
    return bound(n_bytes, 2 * chw * K + 2 * chw * CAS_OPS_PER_PIXEL)


def fused_y_fn(plan, dev, kid: str):
    """The fused-y frame of a u=2 plan on `dev`, (h, w, C) uint8 image ->
    the rows route's x pass (dense.r2c_x_only; U stored as Q2.14 in -p 2),
    then K8 (the planes E, D) or K9 (the woven (C, 2h, W) image)."""
    import torch

    from vkresample_tpu_torch import Engine, Precision
    from vkresample_tpu_torch.fft import dense
    from vkresample_tpu_torch.ops import ycas_cuda
    from vkresample_tpu_torch.ops.cas import to_i16_storage
    from vkresample_tpu_torch.pipeline.upscale import fp32_matmul, make_device_banks

    banks = make_device_banks(plan, Engine.MXU, dev, planes_out=False)
    YT = torch.from_numpy(dense.ycas_bank(plan)).to(dev)
    kernel = ycas_cuda.ycas_parity_u2 if kid == "K8" else ycas_cuda.ycas_u2
    half = plan.precision is Precision.HALF

    def frame(img):
        with fp32_matmul():
            U, T2 = dense.r2c_x_only(img.permute(2, 0, 1).contiguous(), banks)
            return kernel(to_i16_storage(U) if half else U, T2, YT, plan.sharpen)

    return frame


def woven_fn(plan, dev):
    """The woven pre-CAS image of a u=2 plan on `dev` as the JAX A/B and
    CAS-split scripts make it: (h, w, C) uint8 image -> dense.r2c_rows with
    no storage codec (U, O float32, GEMMs in full fp32) -> the float32
    dense.weave_rows image (C, 2h, 2w)."""
    from vkresample_tpu_torch import Engine
    from vkresample_tpu_torch.fft import dense
    from vkresample_tpu_torch.pipeline.upscale import fp32_matmul, make_device_banks

    banks = make_device_banks(plan, Engine.MXU, dev, planes_out=False)

    def woven(img):
        with fp32_matmul():
            U, O = dense.r2c_rows(img.permute(2, 0, 1).contiguous(), banks)
        return dense.weave_rows(U, O, 2)

    return woven


def cas_ab_fn(plan, dev, kid: str, bh):
    """The woven-CAS A/B frame of a u=2 plan on `dev`: woven_fn's image,
    then K3, K6 (bh rows per block) or K7 (bh rows per band): the (C, 2h,
    2w) uint8 image."""
    from vkresample_tpu_torch.ops import cas_cuda

    woven = woven_fn(plan, dev)
    cas = {
        "K3": lambda v: cas_cuda.cas_quantize(v, plan.sharpen),
        "K6": lambda v: cas_cuda.cas_quantize_blocked(v, plan.sharpen, bh),
        "K7": lambda v: cas_cuda.cas_quantize_mono(v, plan.sharpen, bh),
    }[kid]
    return lambda img: cas(woven(img))


def cas_split_fn(plan, dev, kid: str, bh):
    """The CAS-split frame of a u=2 plan on `dev` (scripts/cas_split.py):
    woven_fn's image, then the copy-quantize probe K10a (the tile of K3's
    first design), K10b (K7's band pipeline, bh rows per band) or K10c
    (cas_rows.cu's data movement, K3's now): the (C, 2h, 2w) uint8 image
    quantize_u8 gives."""
    from vkresample_tpu_torch.ops import quantize_cuda

    woven = woven_fn(plan, dev)
    if kid == "K10a":
        return lambda img: quantize_cuda.copy_quantize_tile(woven(img))
    if kid == "K10c":
        return lambda img: quantize_cuda.copy_quantize_rows(woven(img))
    return lambda img: quantize_cuda.copy_quantize_mono(woven(img), bh)


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # 1. device
    require(torch.cuda.is_available(), "no CUDA device: the smoke run needs one GPU")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card}  torch {torch.__version__} cuda {torch.version.cuda}")

    from vkresample_tpu_torch import Engine, Precision, UpscalePlan, _build, build_upscale, upscale
    from vkresample_tpu_torch.fft import dense
    from vkresample_tpu_torch.io.png import read_png, write_png
    from vkresample_tpu_torch.ops import cas_cuda, quantize_cuda, ycas_cuda
    from vkresample_tpu_torch.ops.cas import quantize_u8, to_i16_storage
    from vkresample_tpu_torch.ops.weave import weave_grid_u8, weave_rows_u8
    from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle
    from vkresample_tpu_torch.pipeline.timing import time_amortized
    from vkresample_tpu_torch.pipeline.upscale import _pipeline, make_device_banks, planes_format

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ybanks = {}

    def ybank(h, w):
        """The y bank of the u=2 frame (h, w) on the card, built once."""
        if (h, w) not in ybanks:
            plan = UpscalePlan(h=h, w=w, upscale=2.0)
            ybanks[(h, w)] = torch.from_numpy(dense.ycas_bank(plan)).to(dev)
        return ybanks[(h, w)]

    def planes(shape, n, dtype):
        """n seeded pre-CAS planes over [-0.1, 1.2), Q2.14-stored for int16."""
        ps = [torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1 for _ in range(n)]
        return [to_i16_storage(p) for p in ps] if dtype == torch.int16 else ps

    def misaligned(p):
        """p as a contiguous view one element (2 or 4 bytes) past the start
        of its buffer."""
        buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=dev)
        buf[1:].copy_(p.reshape(-1))
        return buf[1:].view(p.shape)

    def tagged(case):
        """(shape, misaligned?) of a K1, K2, K3 or K10c case: a shape, or
        (shape, "misaligned") for inputs 2 or 4 bytes past a 16-byte
        boundary."""
        return (case[0], True) if case[-1] == "misaligned" else (case, False)

    def image_args(case, dt, n):
        """n seeded planes of a K1 (n = 4), K2 (n = 2) or K3 (n = 1) case."""
        shape, mis = tagged(case)
        ps = planes(shape, n, dt)
        return [misaligned(p) for p in ps] if mis else ps

    def grid_args(case, dt):
        """case (shape, u), or (shape, u, "misaligned") for planes that start
        2 or 4 bytes past a 16-byte boundary."""
        shape, u = case[:2]
        ps = planes(shape, u * u, dt)
        return ([misaligned(p) for p in ps] if len(case) > 2 else ps), u

    def rows_args(case, dt):
        """case (shape, u), or (shape, u, "misaligned") for U and O that start
        2 or 4 bytes past a 16-byte boundary."""
        (c, h, W), u = case[:2]
        U, O = planes((c, h, W), 1, dt)[0], planes((c, h * (u - 1), W), 1, dt)[0]
        return (misaligned(U), misaligned(O), u) if len(case) > 2 else (U, O, u)

    def ycas_args(case, dt):
        """(U, T2, YT): r None = the frame's own y bank, else a random bank
        with r correction rows."""
        (c, h, W), r = case
        if r is None:
            YT = ybank(h, W // 2)
        else:
            YT = torch.randn((h, h + r), generator=gen, device=dev) * (0.6 / (h + r) ** 0.5)
        r = YT.shape[1] - h
        T2 = torch.rand((c, r, W), generator=gen, device=dev) * 0.1 - 0.05 if r else None
        return planes((c, h, W), 1, dt)[0], T2, YT

    def ycas_unfused(U, T2, YT, sharpen):
        """The unfused form of K8: the torch.matmul y GEMM (O stored as Q2.14
        in -p 2, as the rows route does) + K2."""
        O = ycas_cuda.ycas_odd_rows_reference(U, T2, YT)[1]
        return cas_cuda.cas_parity_planes_u2(U, to_i16_storage(O) if U.dtype == torch.int16
                                             else O, sharpen)

    def blocked_bound(v, bh):
        """K6 reads v and its 2*C*nb*W halo rows, writes C*H*W uint8."""
        H, W = v.shape[-2:]
        halo = 2 * (v.numel() // (H * W)) * -(-H // bh) * W * 4
        return bound(v.numel() * 5 + halo, v.numel() * CAS_OPS_PER_PIXEL)

    k3_same = ("K3", lambda v, bh, s: cas_cuda.cas_quantize(v, s))

    def quant_bound(v):
        """A copy-quantize probe reads v once and writes as many uint8."""
        return bound(v.numel() * 5, v.numel() * QUANT_OPS_PER_PIXEL)

    def k5_unfused(U, O, u, s):
        """The unfused form K5 replaces: weave_rows + K3."""
        return cas_cuda.cas_quantize(dense.weave_rows(U, O, u), s)

    # kernel id -> name, wrapper (fn unless given: the function whose launch
    # counter is read), kernel call, plain version, sources, argument cases
    # (the first is the route shape, timed in phase 6), dtypes (int16 and
    # f32 unless given), argument maker, bound from the arguments; exact:
    # identical to the plain version on every pixel; vs: (label, form, max
    # LSB) it is held against in phase 3 (not when max LSB is None) and
    # timed beside in phase 6 unless it is the unfused form; unfused: the
    # unfused form it replaces, timed in phase 6; timed: how many of the
    # first cases phase 6 times (1 unless given)
    kernels = {
        "K1": dict(
            name="cas_parity4_planes_u2", fn=cas_cuda.cas_parity4_planes_u2,
            plain=cas_cuda.cas_parity4_planes_u2_reference,
            source="vkresample_tpu_torch/csrc/cas_grid.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:1432",
            # the route shape (2048x1024 -> 4096x2048), then h and Wh off the
            # 16-row band and 64-column strip, Wh % 4 != 0, Wh % 8 != 0,
            # single rows or columns, and misaligned planes
            cases=[(C, 1024, 2048), (2, 37, 200), (2, 37, 201), (2, 19, 136), (2, 21, 202),
                   (2, 13, 132), (2, 65, 70), (1, 1, 70), (2, 40, 1), (1, 17, 3), (1, 1, 1)]
            + [((2, 21, 136), "misaligned"), ((C, 1024, 2048), "misaligned")],
            args=lambda case, dt: image_args(case, dt, 4),
            bound=lambda a: cas_bound(a[0].shape, 4, a[0].element_size()),
            exact=True,
        ),
        "K2": dict(
            name="cas_parity_planes_u2", fn=cas_cuda.cas_parity_planes_u2,
            plain=cas_cuda.cas_parity_planes_u2_reference,
            source="vkresample_tpu_torch/csrc/cas_rows.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:777",
            # the route shapes (the rows route 1440x1080 -> 2880x2160, the
            # woven flagship 2048x1024 -> 4096x2048), then K5's edge set at
            # u = 2: h and 2h off the 64-row band and W off the 128-column
            # strip, W % 4 != 0, W % 8 != 0, h = 1, W = 1, and misaligned U
            # and O
            cases=[(C, 1080, 2880), (C, 1024, 4096), (2, 37, 200), (2, 32, 136),
                   (2, 65, 131), (2, 21, 202), (2, 13, 132), (1, 1, 70), (1, 1, 129),
                   (2, 40, 1), (1, 1, 1)]
            + [((2, 37, 200), "misaligned"), ((C, 1080, 2880), "misaligned")],
            args=lambda case, dt: image_args(case, dt, 2),
            bound=lambda a: cas_bound(a[0].shape, 2, a[0].element_size()),
            exact=True,
            timed=2,
        ),
        "K3": dict(
            name="cas_quantize", fn=cas_cuda.cas_quantize,
            plain=cas_cuda.cas_quantize_reference,
            source="vkresample_tpu_torch/csrc/cas_rows.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:543",
            # the route shape (-engine xla 1080p -> 4K), the chains' shapes,
            # then K5's edge set at u = 1: H and W off the 64-row band and
            # 128-column strip, W % 4 != 0, W % 8 != 0, H = 1, W = 1, and a
            # misaligned image
            cases=[(C, 2160, 3840), (C, 1080, 1920), (C, 1800, 3200), (2, 37, 201),
                   (2, 37, 200), (2, 65, 131), (2, 21, 202), (2, 13, 132), (2, 64, 136),
                   (2, 130, 129), (1, 1, 70), (1, 1, 129), (2, 40, 1), (1, 1, 1)]
            + [((2, 37, 200), "misaligned"), ((C, 2160, 3840), "misaligned")],
            args=lambda case, dt: image_args(case, dt, 1),
            bound=lambda a: cas_bound(a[0].shape, 1, a[0].element_size()),
            exact=True,
        ),
        "K4": dict(
            name="cas_parity_grid_planes", fn=cas_cuda.cas_parity_grid_planes,
            plain=cas_cuda.cas_parity_grid_planes_reference,
            source="vkresample_tpu_torch/csrc/cas_grid.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:2152",
            # the route shapes (u=3 720p -> 4K, 1.5x, u=4 qHD -> 4K), then h
            # and W off the band and strip edges, W % 4 != 0, single rows or
            # columns, and misaligned planes, at every u
            cases=[((C, 720, 1280), 3), ((C, 360, 640), 3), ((C, 540, 960), 4)]
            + [((2, 37, 200), u) for u in (3, 4, 5, 7)]
            + [((2, 37, 201), u) for u in range(1, 9)]
            + [((2, 19, 136), u) for u in range(1, 9)]
            + [((1, 1, 5), 1), ((1, 1, 70), 3), ((2, 40, 1), 4), ((1, 9, 66), 6),
               ((1, 17, 3), 2), ((1, 1, 1), 8)]
            + [((2, 21, 136), u, "misaligned") for u in (1, 3, 8)]
            + [((C, 540, 960), 4, "misaligned")],
            args=grid_args,
            bound=lambda a: cas_bound(a[0][0].shape, a[1] ** 2, a[0][0].element_size()),
            exact=True,
            timed=3,
        ),
        "K5": dict(
            name="cas_quantize_rows_u", fn=cas_cuda.cas_quantize_rows_u,
            plain=cas_cuda.cas_quantize_rows_u_reference,
            source="vkresample_tpu_torch/csrc/cas_rows.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:473",
            # the route shapes (u=3 720p -> 4K, u=4 qHD -> 4K), then u*h and W
            # off the band and strip edges at u = 2..8 and 11, W % 4 != 0,
            # single rows or columns, and misaligned U and O
            cases=[((C, 720, 3840), 3), ((C, 540, 3840), 4)]
            + [((2, 37, 200), u) for u in range(2, 9)]
            + [((2, 37, 131), 3), ((2, 21, 202), 4), ((2, 13, 132), 5), ((2, 64, 136), 2),
               ((1, 9, 66), 11), ((1, 1, 1), 3), ((1, 1, 70), 2), ((2, 40, 1), 4),
               ((1, 1, 129), 6)]
            + [((2, 37, 200), 3, "misaligned"), ((2, 21, 136), 4, "misaligned"),
               ((C, 540, 3840), 4, "misaligned")],
            args=rows_args,
            bound=lambda a: cas_bound(a[0].shape[:-2] + (a[2] * a[0].shape[-2], a[0].shape[-1]),
                                      1, a[0].element_size()),
            exact=True,
            unfused=k5_unfused,
            vs=("weave_rows + K3", k5_unfused, 0),
            timed=2,
        ),
        "K6": dict(
            name="cas_quantize_blocked", wrapper=cas_cuda.cas_quantize_blocked,
            fn=lambda v, bh, s: cas_cuda.cas_quantize_blocked(v, s, bh),
            plain=lambda v, bh, s: cas_cuda.cas_quantize_blocked_reference(
                v, *cas_cuda.blocked_halo_rows(v, bh), bh, s),
            source="vkresample_tpu_torch/csrc/cas_blocked.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:2427",
            cases=[((C, 2048, 4096), 64), ((C, 2160, 3840), 64)]
            + [((2, 37, 201), bh) for bh in (1, 7, 64)],
            dtypes=(torch.float32,),
            args=lambda case, dt: (planes(case[0], 1, dt)[0], case[1]),
            bound=lambda a: blocked_bound(*a),
            vs=k3_same + (1,),
        ),
        "K7": dict(
            name="cas_quantize_mono", wrapper=cas_cuda.cas_quantize_mono,
            fn=lambda v, bh, s: cas_cuda.cas_quantize_mono(v, s, bh),
            plain=lambda v, bh, s: cas_cuda.cas_quantize_mono_reference(v, s),
            source="vkresample_tpu_torch/csrc/cas_mono.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:2550",
            cases=[((C, 2048, 4096), 128), ((C, 2160, 3840), 128)]
            + [((2, 37, 201), bh) for bh in (1, 32, 128)],
            dtypes=(torch.float32,),
            args=lambda case, dt: (planes(case[0], 1, dt)[0], case[1]),
            bound=lambda a: cas_bound(a[0].shape, 1, 4),
            exact=True,
            vs=k3_same + (0,),
        ),
        "K8": dict(
            name="ycas_parity_u2", fn=ycas_cuda.ycas_parity_u2,
            plain=ycas_cuda.ycas_parity_u2_reference,
            source="vkresample_tpu_torch/csrc/ycas.cu",
            replaces="vkresample_tpu/ops/ycas_pallas.py:406",
            cases=[((C, 1080, 2880), None), ((C, 1024, 4096), None), ((2, 37, 200), 0),
                   ((2, 37, 200), 2), ((2, 1, 200), 1), ((2, 1, 200), 0)],
            args=ycas_args, bound=lambda a: ycas_bound(*a), unfused=ycas_unfused,
        ),
        "K9": dict(
            name="ycas_u2", fn=ycas_cuda.ycas_u2, plain=ycas_cuda.ycas_u2_reference,
            source="vkresample_tpu_torch/csrc/ycas.cu",
            replaces="vkresample_tpu/ops/ycas_pallas.py:509",
            cases=[((C, 1024, 4096), None), ((C, 1080, 2880), None), ((2, 37, 200), 0),
                   ((2, 37, 200), 2), ((2, 1, 200), 1)],
            args=ycas_args, bound=lambda a: ycas_bound(*a),
            unfused=lambda *a: weave_rows_u8(*ycas_unfused(*a)),
        ),
        "K10a": dict(
            name="copy_quantize_tile", wrapper=quantize_cuda.copy_quantize_tile,
            fn=lambda v, s: quantize_cuda.copy_quantize_tile(v),
            plain=lambda v, s: quantize_cuda.copy_quantize_reference(v),
            source="vkresample_tpu_torch/csrc/copy_quantize.cu",
            replaces="scripts/cas_split.py:57",
            cases=[(C, 2048, 4096), (C, 2160, 3840), (2, 37, 201)],
            dtypes=(torch.float32,),
            args=lambda case, dt: planes(case, 1, dt),
            bound=lambda a: quant_bound(a[0]),
            exact=True,
        ),
        "K10b": dict(
            name="copy_quantize_mono", wrapper=quantize_cuda.copy_quantize_mono,
            fn=lambda v, bh, s: quantize_cuda.copy_quantize_mono(v, bh),
            plain=lambda v, bh, s: quantize_cuda.copy_quantize_reference(v),
            source="vkresample_tpu_torch/csrc/copy_quantize.cu",
            replaces="scripts/cas_split.py:57",
            cases=[(shape, bh) for shape in ((C, 2048, 4096), (C, 2160, 3840), (2, 37, 201))
                   for bh in (128, 64, 32, 1)],
            dtypes=(torch.float32,),
            args=lambda case, dt: (planes(case[0], 1, dt)[0], case[1]),
            bound=lambda a: quant_bound(a[0]),
            exact=True,
            vs=("K7 at the same bh", lambda v, bh, s: cas_cuda.cas_quantize_mono(v, s, bh), None),
            timed=2,
        ),
        "K10c": dict(
            name="copy_quantize_rows", wrapper=quantize_cuda.copy_quantize_rows,
            fn=lambda v, s: quantize_cuda.copy_quantize_rows(v),
            plain=lambda v, s: quantize_cuda.copy_quantize_reference(v),
            source="vkresample_tpu_torch/csrc/cas_rows.cu",
            replaces="scripts/cas_split.py:57",
            # the CAS-split frame's woven image, K3's route shape, then off
            # the band and strip edges, W % 4 != 0, W = 1, and misaligned
            cases=[(C, 2048, 4096), (C, 2160, 3840), (2, 37, 201), (2, 65, 131), (2, 40, 1)]
            + [((2, 37, 200), "misaligned")],
            dtypes=(torch.float32,),
            args=lambda case, dt: image_args(case, dt, 1),
            bound=lambda a: quant_bound(a[0]),
            exact=True,
            vs=("K3", lambda v, s: cas_cuda.cas_quantize(v, s), None),
        ),
    }

    def call(k, which, args):
        """Kernel (which="fn"), plain version ("plain"), unfused form
        ("unfused") or the form it is held against ("vs") on the arguments;
        always a tuple of uint8 tensors."""
        fn = k["vs"][1] if which == "vs" else k[which]
        out = fn(*args, 0.2)
        return out if isinstance(out, tuple) else (out,)

    # 2. build
    t0 = time.perf_counter()
    _build.load_kernels()
    print(
        f"[2 build] {_build.last_build['path']}: "
        f"{'compiled' if _build.last_build['compiled'] else 'found built'} "
        f"in {time.perf_counter() - t0:.3f} s (nvcc {_build.last_build['seconds']:.3f} s)"
    )

    # 3. each kernel against its plain version at its routes' shapes
    for kid, k in kernels.items():
        k["max_abs_err"] = 0
        for case in k["cases"]:
            for dt in k.get("dtypes", (torch.float32, torch.int16)):
                args = k["args"](case, dt)
                got = call(k, "fn", args)
                torch.cuda.synchronize()
                d, same = u8_diff(got, call(k, "plain", args))
                print(f"[3 kernels] {kid} {k['name']} {case} {dt}: max|diff| {d} LSB, "
                      f"identical {same:.6f}")
                if k.get("exact"):
                    require(d == 0, f"{kid} differs from its plain version at {case}")
                label, _, tol = k.get("vs", (None, None, None))
                if tol is not None:
                    dv, same_v = u8_diff(got, call(k, "vs", args))
                    print(f"[3 kernels] {kid} {case} {dt} vs {label}: max|diff| {dv} LSB, "
                          f"identical {same_v:.6f} (tol {tol})")
                    require(dv <= tol, f"{kid} differs from {label} at {case}")
                require(d <= TOL_LSB and same >= MIN_IDENTICAL,
                        f"{kid} disagrees with its plain version at {case}")
                k["max_abs_err"] = max(k["max_abs_err"], d)

    # 4. every route at full size, through the user's entry points
    oracles, imgs, fns, route_out = {}, {}, {}, {}
    for k in kernels.values():
        k["launches"] = 0

    def launches_of(run_name, runs):
        """Read and check every kernel's counter after a run."""
        counts = {kid: k.get("wrapper", k["fn"]).launches for kid, k in kernels.items()}
        for kid, n in counts.items():
            require((n > 0) == (kid in runs),
                    f"{run_name}: {kid} launched {n} times, expected {'some' if kid in runs else 'none'}")
            kernels[kid]["launches"] += n
        return counts

    def zero_counters():
        for k in kernels.values():
            k.get("wrapper", k["fn"]).launches = 0

    def image(h, w):
        if (h, w) not in imgs:
            imgs[(h, w)] = np.random.default_rng(SEED + h + w).integers(0, 256, (h, w, C), np.uint8)
        return imgs[(h, w)]

    for route, ((h, w), u, prec, engine, r2c, entry, runs) in ROUTES.items():
        plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec], r2c=r2c,
                           engine=Engine[engine])
        img = image(h, w)
        key = (h, w, u, r2c)
        if key not in oracles:
            t0 = time.perf_counter()
            oracles[key] = upscale_oracle(img, plan)
            print(f"[4 routes] fp64 oracle {w}x{h} -> {plan.W}x{plan.H} "
                  f"{'r2c' if r2c else 'c2c'} in {time.perf_counter() - t0:.3f} s")
        fmt = planes_format(plan) if entry == "planes" else None
        require(entry == "woven" or fmt is not None, f"{route}: no parity planes")
        zero_counters()
        t0 = time.perf_counter()
        if entry == "planes":
            fns[route] = build_upscale(plan, dev, planes_out=True)
            out = fns[route](img)
        else:
            out = upscale(img, u, plan=plan, device=dev)
            fns[route] = build_upscale(plan, dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        counts = launches_of(route, runs)
        for kid in sorted(runs & {"K1", "K2", "K3"}):
            print(f"[4 routes] {route}: {kid} staging form "
                  f"{kernels[kid]['fn'].staging}")
        got = route_out[route] = woven_hwc(out, fmt, plan)
        require(got.shape == (plan.H, plan.W, C) and got.dtype == np.uint8,
                f"{route}: bad output {got.shape} {got.dtype}")
        d = int(np.abs(got.astype(np.int16) - oracles[key].astype(np.int16)).max())
        print(f"[4 routes] {route} ({fmt or 'woven'}): {w}x{h} -> {plan.W}x{plan.H} "
              f"first frame (banks built, uploaded) in {setup:.3f} s; max|diff| vs fp64 "
              f"oracle {d} LSB; launches {counts}")
        require(d <= TOL_LSB, f"{route} is {d} LSB from the oracle")

    # the fused-y runs: the rows route's x pass, then K8 or K9
    fused_fns = {}
    for run, ((h, w), prec, kid, against) in FUSED.items():
        plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision[prec])
        frame = fused_fns[run] = fused_y_fn(plan, dev, kid)
        x = torch.from_numpy(image(h, w)).to(dev)
        zero_counters()
        out = frame(x)
        torch.cuda.synchronize()
        counts = launches_of(run, {kid})
        got = woven_hwc(out, "rows" if kid == "K8" else "planar", plan)
        d = int(np.abs(got.astype(np.int16) - oracles[(h, w, 2.0, True)].astype(np.int16)).max())
        dr, same = u8_diff([got], [route_out[against]])
        bar = MIN_IDENTICAL_VS_Q214_ROUTE if prec == "HALF" else MIN_IDENTICAL
        print(f"[4 routes] {run}: {w}x{h} -> {plan.W}x{plan.H}, max|diff| vs fp64 oracle {d} "
              f"LSB; vs route {against}: max|diff| {dr} LSB, identical {same:.6f} "
              f"(bar {bar}); launches {counts}")
        require(d <= TOL_LSB, f"{run} is {d} LSB from the oracle")
        require(dr <= TOL_LSB and same >= bar, f"{run} disagrees with the route {against}")

    # the woven-CAS A/B runs: r2c_rows, weave_rows, then K3, K6 or K7
    ab_fns = {}
    h, w = CAS_AB_FRAME
    ab_plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
    ab_x = torch.from_numpy(image(h, w)).to(dev)
    for run, (kid, bh) in CAS_AB.items():
        frame = ab_fns[run] = cas_ab_fn(ab_plan, dev, kid, bh)
        zero_counters()
        out = frame(ab_x)
        torch.cuda.synchronize()
        counts = launches_of(run, {kid})
        got = woven_hwc(out, "planar", ab_plan)
        require(got.shape == (ab_plan.H, ab_plan.W, C) and got.dtype == np.uint8,
                f"{run}: bad output {got.shape} {got.dtype}")
        d = int(np.abs(got.astype(np.int16) - oracles[(h, w, 2.0, True)].astype(np.int16)).max())
        print(f"[4 routes] {run}: {w}x{h} -> {ab_plan.W}x{ab_plan.H}, max|diff| vs fp64 oracle "
              f"{d} LSB; launches {counts}")
        require(d <= TOL_LSB, f"{run} is {d} LSB from the oracle")

    # the CAS-split runs: the A/B frame's woven image, then K10a or K10b,
    # against the plain quantize of the same woven image on the card
    split_fns = {}
    want_q = quantize_u8(woven_fn(ab_plan, dev)(ab_x))
    for run, (kid, bh) in CAS_SPLIT.items():
        frame = split_fns[run] = cas_split_fn(ab_plan, dev, kid, bh)
        zero_counters()
        out = frame(ab_x)
        torch.cuda.synchronize()
        counts = launches_of(run, {kid})
        require(out.shape == want_q.shape and out.dtype == torch.uint8,
                f"{run}: bad output {tuple(out.shape)} {out.dtype}")
        n_diff = int((out != want_q).sum())
        print(f"[4 routes] {run}: {w}x{h} -> {ab_plan.W}x{ab_plan.H}, pixels differing from "
              f"quantize_u8 of the woven image: {n_diff}; launches {counts}")
        require(n_diff == 0, f"{run} differs from quantize_u8 of its woven image")

    # TF32: a caller's matmul precision does not reach a cached pipeline
    route = "quad -p 0"
    (h, w), u, prec = ROUTES[route][:3]
    plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec])
    x = torch.from_numpy(image(h, w)).to(dev)
    caller = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        zero_counters()
        out = fns[route](x)
        torch.cuda.synchronize()
        counts = launches_of(f"TF32 check {route}", {"K1"})
        kept = torch.get_float32_matmul_precision()
        unpinned = _pipeline(x, make_device_banks(plan, Engine.MXU, dev, planes_out=True),
                             plan, Engine.MXU, True, True)  # the frame without the pin
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(caller)
    key = (h, w, u, True)
    d, d_tf32 = (int(np.abs(woven_hwc(o, "quad", plan).astype(np.int16)
                            - oracles[key].astype(np.int16)).max()) for o in (out, unpinned))
    d_pin, same_pin = u8_diff(out, unpinned)
    print(f"[4 routes] TF32 check {route} under set_float32_matmul_precision('high'): max|diff| "
          f"vs fp64 oracle {d} LSB; the frame without the pin: {d_tf32} LSB from the oracle, "
          f"{d_pin} LSB from the pinned frame, identical {same_pin:.6f}; caller's setting "
          f"after the call {kept!r}; launches {counts}")
    require(d <= TOL_LSB, f"TF32 check: {route} is {d} LSB from the oracle under 'high'")
    require(kept == "high", f"TF32 check: the call changed the caller's setting to {kept!r}")
    for kid, k in kernels.items():
        print(f"[4 routes] {kid} {k['name']} launches over the routes and runs: {k['launches']}")

    # 5. the CLI on the samples, the golden PNGs and a non-aligned frame
    out_dir = os.path.join(ROOT, "vkresample_tpu_torch", "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    samples = os.path.join(ROOT, "samples")
    na = os.path.join(out_dir, "nonaligned_600x400.png")
    write_png(na, np.random.default_rng(SEED).integers(0, 256, (400, 600, C), np.uint8))
    runs = [
        ("1920x1080 -u 2 -p 2", os.path.join(samples, "test_1920x1080.png"), ["-u", "2", "-p", "2"]),
        ("256x128 -u 2", os.path.join(samples, "test_256x128.png"), ["-u", "2"]),
        ("256x128 -u 1.5", os.path.join(samples, "test_256x128.png"), ["-u", "1.5"]),
        ("600x400 -u 2 -p 2", na, ["-u", "2", "-p", "2"]),
        ("1920x1080 -c2c -u 2 -p 2", os.path.join(samples, "test_1920x1080.png"),
         ["-c2c", "-u", "2", "-p", "2"]),
        ("600x400 -c2c -u 3", na, ["-c2c", "-u", "3"]),
    ]
    outs = {}
    for label, src, extra in runs:
        outs[label] = os.path.join(out_dir, "cli_" + label.replace(" ", "_") + ".png")
        cmd = [sys.executable, "-m", "vkresample_tpu_torch", "-i", src, "-o", outs[label],
               *extra, "-validate"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"[5 cli] {label}: {line}")
        require(proc.returncode == 0 and "(tol 1) OK" in proc.stdout,
                f"CLI {label} exited {proc.returncode}: {proc.stderr[-2000:]}")
    require(read_png(outs["600x400 -u 2 -p 2"]).shape == (800, 1200, C),
            "CLI output of the non-aligned frame has the wrong shape")
    require(read_png(outs["600x400 -c2c -u 3"]).shape == (1200, 1800, C),
            "CLI -c2c -u 3 output has the wrong shape")
    for label, golden in (("256x128 -u 2", "golden_256x128_x2.png"),
                          ("256x128 -u 1.5", "golden_256x128_x1.5.png")):
        got, gold = read_png(outs[label]), read_png(os.path.join(samples, golden))
        require(got.shape == gold.shape, f"CLI {label}: shape {got.shape} vs golden {gold.shape}")
        d = int(np.abs(got.astype(np.int16) - gold.astype(np.int16)).max())
        print(f"[5 cli] {label} vs {golden}: max|diff| {d} LSB")
        require(d <= TOL_LSB, f"CLI {label} differs from {golden}")

    # 6. times, on this card
    for route, fn in fns.items():
        (h, w), u = ROUTES[route][:2]
        x = torch.from_numpy(imgs[(h, w)]).to(dev)
        _, ms = time_amortized(fn, (x,), 20, dev)
        print(f"[6 times] route {route} {w}x{h} x{u}: {ms:.4f} ms/frame "
              f"(-n 20, CUDA events) on {card}")
    for run, fn in fused_fns.items():
        (h, w) = FUSED[run][0]
        x = torch.from_numpy(imgs[(h, w)]).to(dev)
        _, ms = time_amortized(fn, (x,), 20, dev)
        print(f"[6 times] {run} {w}x{h} x2 (r2c_x_only + {FUSED[run][2]}): {ms:.4f} ms/frame "
              f"(-n 20, CUDA events) on {card}")
    for runs, fns_ in ((CAS_AB, ab_fns), (CAS_SPLIT, split_fns)):
        for run, fn in fns_.items():
            _, ms = time_amortized(fn, (ab_x,), 20, dev)
            print(f"[6 times] {run} {ab_plan.w}x{ab_plan.h} x2 (r2c_rows + weave_rows + "
                  f"{runs[run][0]}): {ms:.4f} ms/frame (-n 20, CUDA events) on {card}")
    for kid, k in kernels.items():
        for case, dt in ((case, dt) for case in k["cases"][:k.get("timed", 1)]
                         for dt in k.get("dtypes", (torch.int16, torch.float32))):
            args = k["args"](case, dt)
            ms = cuda_ms(lambda: call(k, "fn", args), 50)
            plain_ms = cuda_ms(lambda: call(k, "plain", args), 10)
            bound_ms, bound_by = k["bound"](args)
            extra = ""
            if "unfused" in k:
                extra = f", unfused form {cuda_ms(lambda: call(k, 'unfused', args), 50):.4f} ms"
            elif "vs" in k:
                extra = f", {k['vs'][0]} {cuda_ms(lambda: call(k, 'vs', args), 50):.4f} ms"
            print(f"[6 times] {kid} {k['name']} {case} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms{extra}, bound {bound_ms:.4f} ms ({bound_by}) on {card}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("bound_by", bound_by)):
                k.setdefault(key, v)  # the int16 reading goes into the JSON line
    # the eager times above include each wrapper's host work, which for K4
    # takes about as long as its kernel: the device alone of the redesigned
    # kernels K1, K2, K3, K4 and K5, printed only
    for kid in ("K1", "K2", "K3", "K4", "K5"):
        k = kernels[kid]
        for case, dt in ((case, dt) for case in k["cases"][:k.get("timed", 1)]
                         for dt in (torch.int16, torch.float32)):
            args = k["args"](case, dt)
            print(f"[6 times] {kid} {k['name']} {case} {dt}: device alone "
                  f"{graph_ms(lambda: call(k, 'fn', args), 50):.4f} ms (50 calls replayed "
                  f"from one CUDA graph) on {card}")
    grid_u8 = [torch.randint(0, 256, (C, 720, 1280), generator=gen, device=dev,
                             dtype=torch.uint8) for _ in range(9)]
    ms = cuda_ms(lambda: weave_grid_u8(grid_u8, 3), 50)
    print(f"[6 times] weave_grid_u8 9 x {(C, 720, 1280)} uint8 (stack + reshape): "
          f"{ms:.4f} ms on {card}")

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda"} | {key: k[key] for key in (
            "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by")} | {"library_ms": None}
        for k in kernels.values()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
