"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's routes (vkresample_tpu_torch: R2C and c2c upscale with
CAS sharpen, half storage -p 2, fp32 -p 0 and fp64 -p 1, the small dense
tier and the big tier beyond it) on the card at full frame sizes, and fails
(non-zero exit, no result line) unless every phase passes:

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
              at both fused-y frames with the frame's y bank and at the
              edges of their 128 x 128 tile (h = 1, 37, 127, 128, 129,
              255, 300; W = 1, 126, 127, 128, 129, 200, 257; K = h + r on
              and off multiples of 8 and 32, r = 0, 1, 2, 4; U 2 or 4
              bytes off alignment), K9 equal to the woven K8 and one
              launch per wrapper call on every case; K6
              (f32 only; cas_rows.cu's block-local instance) with random
              halo rows, not v's own, at the A/B frame's (3, 2048, 4096)
              bh 64, the sp rows form's flagship shards (3, 1024, 4096)
              and (3, 512, 4096) as one block, K3's (3, 2160, 3840) and
              (2, 37, 201) at bh 1, 7, 64 and odd or ragged cases,
              identical on every pixel to its plain version; K3's
              column-halo entry K3h with random halo columns at the sp
              column forms' shard blocks (3, 2048, 4096 / S) and (3, 2160,
              3840 / S), S = 1, 2, 4, and odd and single-column blocks,
              identical on every pixel to its plain version; K7 (f32
              only; the persistent streaming pipeline of
              csrc/stream_pipeline.cuh) at (3, 2048, 4096) bh 128 and 64,
              (3, 2160, 3840), and at the pipeline's edges: bh 1, 7, 32,
              128, 1000 and past H, W = 4100 and 4097, H = 1, W = 1, H one
              row past a segment multiple, 24 planes, and views one float
              off a 16-byte boundary, identical to its plain version and
              to K3 on every pixel, each case's copy form (bulk or per
              element) printed as its staging, each call bounded in time
              (a hung ring fails the run); the copy-quantize
              probes K10a (the tile of K3's first design), K10b (K7's
              pipeline, on K7's cases) and K10c (the copy-only instance of
              cas_rows.cu's kernel, K5's, K3's and K2's data movement),
              f32 only, K10a at (3, 2048, 4096), (3, 2160, 3840) and (2,
              37, 201), K10c also at odd and misaligned images, identical
              on every pixel to their plain version; then the big tier's
              shapes, int16 and f32: K1 at 4 x
              (3, 4096, 8192) (the staged quad and the c2c grid u=2 at 8K
              -> 16K), 4 x (3, 4320, 8640) and 4 x (3, 8192, 16384), K4 at
              9 x (3, 2160, 3840), K3 at (3, 8192, 16384), identical on
              every pixel to their plain versions run in row bands with a
              one-row halo (the whole image's output in bounded memory),
              compared on the card, each timed (10 wrapper calls); K3h at
              the large sp frame's S = 2 column shard (3, 8192, 8192), the
              same way
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
              the device time alone of K1, K2, K3, K3h, K4, K5, K6, K7,
              K8, K9 and K10b: 50 calls replayed from one CUDA graph, since
              K4's wrapper takes about as long on the host as its kernel on
              the device; K8 and K9 at both fused-y shapes, beside their
              unfused form's and its y GEMM's device time and the fp32 FMA
              form's bound; K7 and K10b at (3, 2048, 4096) bh 128 and 64
              beside K3's and K10c's on the same image, each with the bound
              and its share),
              the unfused forms K5, K8
              and K9 replace (weave_rows + K3; torch.matmul y GEMM, Q2.14
              store in -p 2, + K2, woven for K9),
              K3 beside K6 and K7 at their shape, K10c beside K3 and K10b
              beside K7 (bh 128 and 64) at (3, 2048, 4096), and the device
              grid weave
  7. batched  build_batched_upscale (N = 3 seeded frames, the route's kernel
              launched once per batch with N*3 planes) on each kernel's route:
              quad 2048x1024 -p 2 and -p 0 (K1), rows 1440x1080 (K2), u=3
              1280x720 (K5), the 1.5x chain (K3), -c2c u=3 1280x720 (K4),
              the first and last frame <= 1 LSB from the fp64 oracle and every
              frame <= 1 LSB from the single-frame call; the folder CLI
              in-process on the card (12 seeded 2048x1024 frames, -u 2 -p 2
              -batch 8 -numthreads 8: two K1 launches, every output <= 1 LSB
              from the single-frame pipeline, then -resume skipping all 12);
              then, printed only: device ms/frame of the batched call at N =
              1, 4, 8 beside build_upscale (-n 20, CUDA events, in turns), a
              batch of 8's host <-> device transfers (pageable, as the CLI's
              loop has them; device -> host also into pinned buffers), decode and
              encode seconds per frame (one thread; 8 frames on 8 threads),
              the CLI's frames/s on 24 frames, and the zlib reader's decode
              of one Paeth-filtered 2048x1024 frame with the C and the Python
              row filters

  8. big     the big tier (axes beyond the 8192 dense cap) and fp64
              (-p 1) through the user's entry points, 3 seeded channels:
                staged quad   8192x4096 -> 16384x8192, -p 2 and -p 0
                              (planes), -p 2 woven upscale()           K1
                staged quad   8640x4320 -> 17280x8640, -p 2 (a width 128
                              does not divide)                          K1
                big grid u=3  3840x2160 -> 11520x6480, -p 2             K4
                big c2c u=2   8192x4096 -> 16384x8192, -p 2             K1
                xla           -engine xla 8192x4096 -> 16384x8192, -p 0 K3
                fp64          2048x1024 u=2 (staged64), 1280x720 u=3
                              (grid64) and -c2c (c2cgrid64), and the
                              8192x4096 u=2 frame                       none
                capacity      16384x8192 -> 32768x16384, -engine xla -p 0
                              (K3), then the staged quad -p 2 (K1), once
              each within 1 LSB of the fp64 oracle (computed in worker
              processes beside phases 3-5), the capacity quad within 1
              LSB of the reference tier's output on the card (a numpy
              oracle at that size takes minutes); every kernel's counter is
              set to 0 before each run and read after it, > 0 exactly for
              the run's kernels (none for fp64); for each run ms/frame (-n
              3 after a warm-up, CUDA events; the capacity frames -n 1), the
              peak device memory, and the bank build time cold
              and from the disk cache (a cache of the run's own, under
              vkresample_tpu_torch/build/smoke); then the CLI at 4320x512
              -> 8640x1024 with -validate, -p 2 and -p 1
  9. engine  the engine surface (ops/convolve.py, fft/ndim.py) through its
              entry points at full width, seeded f32 inputs, each within
              1e-5 * max|want| of float64 np.fft on the host (computed in
              worker processes beside phases 6-8), ms per call (20 calls
              after a warm-up, CUDA events), no CAS kernel launched:
                fft_convolve2d, Gaussian sigma 2.5, auto
                                         (3, 1024, 2048), (4096, 4096)
                the same, mxu            (3, 1024, 2048)
                fft_convolve2d, random kernel, auto
                                         (3, 1024, 2048), (4096, 4096)
                fft_convolve2d, a bank of 4 kernels (3, 1024, 2048)
                fft_matrix_convolve2d, 3x3           (3, 1024, 2048)
                fft_convolve2d_linear, 31x31 kernel  (3, 1080, 1920)
                fftn forward and inverse             (256, 256, 256)
                rfftn -> irfftn        (256, 256, 256), (64, 96, 135)
              then the flagship CLI -u 2 -p 2 -n 5 in three alternating
              pairs without and with -profile DIR (K1 launched in each),
              whose torch.profiler traces must parse as JSON and name K1's
              kernel and a GEMM; the first trace's five largest device
              kernels printed
 10. sp, dp   K6's shard wrapper (cas_quantize_blocked_halo, the shard
              one block) at the flagship's shard shapes (3, 2048, 4096),
              (3, 1024, 4096) and (3, 512, 4096), and each column form's
              whole shard CAS (cas_quantize_cols_halo) at (3, 2048, 4096 /
              S) and (3, 2160, 3840 / S), S = 1, 2, 4, int16 and f32, and
              (3, 8192, 8192) int16: identical on every pixel to their
              plain versions and to the parent's forms (gathered 64-row
              blocks; concat + K3 + crop), timed eager (50 calls) and on
              the device alone (from a CUDA graph) beside the parent's
              readings, the parent's form in the same run and the bound;
              torch.profiler counts one CAS kernel and no other device
              kernel or copy in each; then the sp pencil mode through its
              five builders on
              every rank, 3 seeded channels, -p 2 and -p 0:
                rows (cuFFT pencils, K6)   2048x1024 -> 4096x2048     K6
                dense, staged              2048x1024 -> 4096x2048     K3h
                grid u=3                   1280x720 -> 3840x2160      K3h
                c2c grid u=2               2048x1024 -> 4096x2048     K3h
              at S = 1 over NCCL and S = 2 and 4 as processes sharing the
              card over gloo (parallel/launch.py::spawn, one spawn per S
              running every case, its own timeout), and the staged -p 2
              8192x4096 -> 16384x8192 frame at S = 2: each gathered frame
              within 1 LSB of the fp64 oracle and of the single-card
              upscale(), the form's kernel launched once per frame on each
              rank and no other CAS kernel; ms/frame per rank (-n 5, CUDA
              events), the share in collectives, peak device memory per
              rank (the big frame's beside the single card's); then a dp
              batch, build_batched_upscale over [cuda:0, cuda:0] on 8
              flagship frames -p 2: each device's 4 frames identical to the
              one-device call on them, all 8 within 1 LSB of the one-device
              batch of 8 (cuBLAS tiles by batch size), K1 once per device

The line before the card's line lists each kernel with its launches over
the routes and runs, its worst difference, its time, its plain version's
time and its bound: the larger of the bytes it must move (inputs read
once, outputs written once; K6's halo rows and K3h's halo columns
included) over 3.35 TB/s and
its fp32 operations (~40 per output pixel
for the CAS, 3 for the quantize) over 67 TFLOP/s (H100 SXM); for the fused
y GEMM + CAS kernels, also the y GEMM in their form, 3 TF32 products per
multiply-add (3 * 2*C*h*(h+r)*W operations) over the 495 TFLOP/s TF32
tensor-core peak, the larger of that and the CAS's time (phase 6 prints
the same GEMM at the fp32 FMA rate beside it).  No single PyTorch call computes CAS, with or
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
KERNEL_TIMEOUT_S = 60  # a phase-3 kernel call, from launch to its end on the card
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores (K8, K9)
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


def bounded_sync(what: str, seconds: float) -> None:
    """Wait for the current stream's work, at most `seconds`: a kernel that
    never ends (the streaming kernels trap after ~20 s of waiting on one
    barrier) fails the run instead of hanging it."""
    import torch

    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        require(time.perf_counter() - t0 < seconds,
                f"{what}: the kernel did not finish within {seconds} s")
        time.sleep(0.001)


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


def halo_bound(a):
    """Bound of K6 or K3h on (v, its two halo tensors, ...): v and the halos
    read once, as many uint8 pixels as v written."""
    v, es = a[0], a[0].element_size()
    return bound(v.numel() * (es + 1) + (a[1].numel() + a[2].numel()) * es,
                 v.numel() * CAS_OPS_PER_PIXEL)


def ycas_bound(U, T2, YT, tensor_cores=True):
    """Bound of a fused y-GEMM + CAS kernel: U, T2 and YT read once, 2*C*h*W
    uint8 written; the y GEMM in the kernels' form, 3 TF32 products per
    multiply-add (3 * 2*C*h*(h+r)*W operations) over the TF32 tensor-core
    peak, beside the CAS's fp32 operations over the fp32 peak (other units:
    the larger of the two).  tensor_cores=False: the form before, the
    GEMM's 2*C*h*(h+r)*W operations plus the CAS's at the fp32 FMA rate."""
    h, K = YT.shape
    chw = U.numel()
    n_bytes = (chw * U.element_size() + (0 if T2 is None else T2.numel() * 4)
               + YT.numel() * 4 + 2 * chw)
    if not tensor_cores:
        return bound(n_bytes, 2 * chw * K + 2 * chw * CAS_OPS_PER_PIXEL)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(3 * 2 * chw * K / TF32_OPS_PER_S, 2 * chw * CAS_OPS_PER_PIXEL / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


# batched run -> ((h, w), upscale, precision, r2c, its kernel): N = 3 frames
# through build_batched_upscale as the folder CLI calls it (the parity planes
# where the route has them, else planar frames)
BATCHED = {
    "quad -p 2": ((1024, 2048), 2.0, "HALF", True, "K1"),
    "quad -p 0": ((1024, 2048), 2.0, "SINGLE", True, "K1"),
    "rows -p 2": ((1080, 1440), 2.0, "HALF", True, "K2"),
    "u=3 -p 2": ((720, 1280), 3.0, "HALF", True, "K5"),
    "chain 1.5x -p 0": ((720, 1280), 1.5, "SINGLE", True, "K3"),
    "c2c grid u=3 -p 2": ((720, 1280), 3.0, "HALF", False, "K4"),
}
BATCH_N = 3
FOLDER_FRAMES = 12  # -batch 8: a batch of 8, then a tail of 4
RATE_FRAMES = 24  # the frames/s run: three batches of 8


def paeth_png(path: str, img) -> None:
    """Write (h, w, 3) uint8 as an 8-bit RGB PNG with every row Paeth
    filtered (what adaptive encoders pick for most rows of photographs)."""
    import zlib

    import numpy as np

    from vkresample_tpu_torch.io import png

    h, w, _ = img.shape
    raw = img.reshape(h, 3 * w).astype(np.int16)
    a, b, c = (np.zeros_like(raw) for _ in range(3))
    a[:, 3:], b[1:], c[1:, 3:] = raw[:, :-3], raw[:-1], raw[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 4
    rows[:, 1:] = ((raw - pred) & 0xFF).astype(np.uint8)
    ihdr = (w).to_bytes(4, "big") + (h).to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(png._SIG + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + png._chunk(b"IEND", b""))


def batch_frames_hwc(out, fmt, plan):
    """A batched call's planar output (N, C, H, W), or its parity planes of
    `fmt` each (N, C, ...), as N (H, W, C) uint8 host frames."""
    n = (out if fmt is None else out[0]).shape[0]
    if fmt is None:
        return [woven_hwc(out[i], "planar", plan) for i in range(n)]
    return [woven_hwc(tuple(p[i] for p in out), fmt, plan) for i in range(n)]


def run_cli(argv):
    """The port's CLI in-process on CUDA device 0: (exit code, stdout lines)."""
    import contextlib
    import io

    from vkresample_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def batched_phase(dev, card, kernels, oracles, image, zero_counters):
    """Phase 7: build_batched_upscale on each kernel's route (N = 3 frames,
    one launch of the route's kernel per batch), the folder CLI on the card,
    and the batched path's times: device ms/frame at N = 1, 4, 8 beside the
    single frame, the host <-> device transfers of a batch, the CLI's
    frames/s with decode and encode alone, and the zlib reader's Paeth
    decode (scripts/torch_folder_host.py times it beside the Python row
    loops)."""
    import shutil

    import numpy as np
    import torch

    from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_batched_upscale
    from vkresample_tpu_torch import build_upscale
    from vkresample_tpu_torch.io import png
    from vkresample_tpu_torch.io.folder import frame_paths
    from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle
    from vkresample_tpu_torch.pipeline.timing import time_amortized
    from vkresample_tpu_torch.pipeline.upscale import planes_format

    def counts():
        return {kid: k.get("wrapper", k["fn"]).launches for kid, k in kernels.items()}

    def expect_launches(run, kid, n):
        got = counts()
        require(got[kid] == n and sum(got.values()) == n,
                f"{run}: launches {got}, expected {n} of {kid} and none else")
        kernels[kid]["launches"] += n
        return got

    last_oracles = {}
    for run, ((h, w), u, prec, r2c, kid) in BATCHED.items():
        plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec], r2c=r2c,
                           engine=Engine.AUTO)
        rng = np.random.default_rng(SEED + 7 + h + w)
        frames = np.stack([image(h, w)] + [rng.integers(0, 256, (h, w, C), np.uint8)
                                           for _ in range(BATCH_N - 1)])
        key = (h, w, u, r2c)
        if key not in last_oracles:
            last_oracles[key] = upscale_oracle(frames[-1], plan)
        fmt = planes_format(plan)
        fn = build_batched_upscale(plan, dev, planar_out=True, planes_out=fmt is not None)
        x = torch.from_numpy(frames).to(dev)
        fn(x)  # banks built, uploaded
        torch.cuda.synchronize()
        zero_counters()
        out = fn(x)
        torch.cuda.synchronize()
        got_counts = expect_launches(f"batched {run}", kid, 1)
        got = batch_frames_hwc(out, fmt, plan)
        require(len(got) == BATCH_N and all(g.shape == (plan.H, plan.W, C) for g in got),
                f"batched {run}: bad output {[g.shape for g in got]}")
        single = build_upscale(plan, dev, planes_out=fmt is not None, planar_out=True)
        one = [woven_hwc(single(f), fmt or "planar", plan) for f in frames]
        d_first = u8_diff([got[0]], [oracles[key]])[0]
        d_last = u8_diff([got[-1]], [last_oracles[key]])[0]
        d_one, same = u8_diff(got, one)
        print(f"[7 batched] {run}: {BATCH_N} x {w}x{h} -> {plan.W}x{plan.H} "
              f"({fmt or 'planar'}), max|diff| vs fp64 oracle first frame {d_first}, last "
              f"frame {d_last} LSB; vs the single-frame call {d_one} LSB, identical "
              f"{same:.6f}; launches {got_counts}")
        require(max(d_first, d_last) <= TOL_LSB, f"batched {run} is off the oracle")
        require(d_one <= TOL_LSB, f"batched {run} differs from the single-frame call")

    # the folder CLI on the card: 12 frames at -batch 8 (8, then a tail of 4)
    root = os.path.join(ROOT, "vkresample_tpu_torch", "build", "smoke", "batched")
    shutil.rmtree(root, ignore_errors=True)
    inp, outp, outp24 = (os.path.join(root, d) for d in ("inp", "outp", "outp24"))
    for d in (inp, outp, outp24):
        os.makedirs(d)
    (h, w), u, prec = BATCHED["quad -p 2"][:3]
    plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec])
    rng = np.random.default_rng(SEED + 12)
    frames = rng.integers(0, 256, (RATE_FRAMES, h, w, C), np.uint8)
    with png.PngPool(8) as pool:
        pool.encode_batch(frame_paths(inp, RATE_FRAMES), frames)
    argv = ["-ifolder", inp, "-ofolder", outp, "-numfiles", str(FOLDER_FRAMES), "-u", "2",
            "-p", "2", "-batch", "8", "-numthreads", "8"]
    zero_counters()
    rc, lines = run_cli(argv)
    for line in lines:
        print(f"[7 batched] cli: {line}")
    require(rc == 0, f"folder CLI exited {rc}")
    print(f"[7 batched] cli launches {expect_launches('folder CLI', 'K1', 2)}")
    single = build_upscale(plan, dev, planes_out=True, planar_out=True)
    worst, same_all = 0, []
    for f, path in zip(frames, frame_paths(outp, FOLDER_FRAMES)):
        d, same = u8_diff([png.read_png(path)], [woven_hwc(single(f), "quad", plan)])
        worst = max(worst, d)
        same_all.append(same)
    print(f"[7 batched] cli: {FOLDER_FRAMES} outputs vs the single-frame pipeline: max|diff| "
          f"{worst} LSB, identical {min(same_all):.6f} (worst frame)")
    require(worst <= TOL_LSB, "folder CLI output differs from the single-frame pipeline")
    rc, lines = run_cli(argv + ["-resume"])
    for line in lines:
        print(f"[7 batched] cli -resume: {line}")
    require(rc == 0 and f"Resume: skipping {FOLDER_FRAMES} already-upscaled frames" in lines
            and "Resume: nothing to do" in lines, "folder CLI -resume did not skip every frame")

    # device ms/frame of the batched call at N = 1, 4, 8 beside the single frame
    fn_one = build_upscale(plan, dev, planes_out=True, planar_out=True)
    fn = build_batched_upscale(plan, dev, planar_out=True, planes_out=True)
    x8 = torch.from_numpy(frames[:8]).to(dev)
    for n in (0, 1, 4, 8):
        if n == 0:
            _, ms = time_amortized(fn_one, (x8[0],), 20, dev)
        else:
            _, ms = time_amortized(fn, (x8[:n],), 20, dev)
            ms /= n
        what = "build_upscale, one frame" if n == 0 else f"build_batched_upscale N = {n}"
        print(f"[7 batched] times: {what}: {ms:.4f} ms/frame (quad -p 2 {w}x{h} -> "
              f"{plan.W}x{plan.H}, -n 20 calls, CUDA events) on {card}")

    # host <-> device transfers of one batch of 8, pageable memory as the loop has it
    h2d, d2h = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd = torch.from_numpy(frames[:8]).to(dev)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
        out = fn(xd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [p.cpu().numpy() for p in out]
        d2h.append((time.perf_counter() - t0) * 1e3)
    print(f"[7 batched] times: host -> device 8 x {h}x{w}x3 uint8 ({frames[:8].nbytes} bytes): "
          f"{', '.join(f'{m:.4f}' for m in h2d)} ms; device -> host 4 quad planes "
          f"({sum(p.nbytes for p in host)} bytes): {', '.join(f'{m:.4f}' for m in d2h)} ms, "
          f"pageable, host clock after a synchronize, on {card}")

    # decode and encode alone: 8 frames on 8 threads, one frame on one thread
    paths = frame_paths(inp, 8)
    outs = [os.path.join(root, f"enc{i}.png") for i in range(8)]
    with png.PngPool(8) as pool:
        t0 = time.perf_counter()
        pool.decode_batch(paths, w, h)
        dec8 = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool.encode_batch_planar_parity4(outs, host)
        enc8 = time.perf_counter() - t0
    t0 = time.perf_counter()
    png.read_png(paths[0])
    dec1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    png.write_png_planar_parity4(outs[0], [p[0] for p in host])
    enc1 = time.perf_counter() - t0
    print(f"[7 batched] times: decode {w}x{h} frames: {dec1:.6f} s/frame on one thread, "
          f"{dec8 / 8:.6f} s/frame for 8 on 8 threads; encode {plan.W}x{plan.H} from quad "
          f"planes: {enc1:.6f} s/frame on one thread, {enc8 / 8:.6f} s/frame for 8 on 8 "
          f"threads (codec {png._codec})")

    # the CLI end to end: 24 frames, -batch 8 -numthreads 8
    rc, lines = run_cli(["-ifolder", inp, "-ofolder", outp24, "-numfiles", str(RATE_FRAMES),
                         "-u", "2", "-p", "2", "-batch", "8", "-numthreads", "8"])
    for line in lines:
        print(f"[7 batched] cli {RATE_FRAMES} frames: {line}")
    require(rc == 0 and any(line.startswith(f"Upscaled {RATE_FRAMES} frames") for line in lines),
            f"folder CLI on {RATE_FRAMES} frames exited {rc}")

    # the zlib reader's Paeth decode (the codec of a card machine without libpng)
    paeth = os.path.join(root, "paeth.png")
    paeth_png(paeth, frames[0])
    t0 = time.perf_counter()
    img = png._zlib_read(paeth)
    ms = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(img, frames[0]), "the Paeth frame decodes wrong")
    filters = "in C" if png._filters() is not None else "in Python: g++ is absent"
    print(f"[7 batched] times: zlib reader, one Paeth-filtered {w}x{h} RGB frame: {ms:.3f} ms "
          f"(row filters {filters}, host clock)")
    shutil.rmtree(root, ignore_errors=True)



# the big tier's kernel shapes (phase 3): K1 at the staged quad's 8K -> 16K
# (and the c2c grid's u=2 at the same frame), the non-aligned 8640 and the
# 16K -> 32K capacity frame; K4 at the u=3 big grid 3840x2160 -> 11520x6480;
# K3 at the reference tier's 8K -> 16K woven image
BIG_KERNEL_CASES = [
    ("K1", (C, 4096, 8192)), ("K1", (C, 4320, 8640)), ("K1", (C, 8192, 16384)),
    ("K4", ((C, 2160, 3840), 3)), ("K3", (C, 8192, 16384)),
    # the large sp frame's S = 2 column shard, its halo columns by pointer
    ("K3h", (C, 8192, 8192)),
]

# big-tier and fp64 run -> ((h, w), upscale, precision, engine, r2c, entry,
# kernels it runs): 3 seeded channels at full width, each through the entry
# point a user calls
BIG = {
    "staged quad -p 2": ((4096, 8192), 2.0, "HALF", "AUTO", True, "planes", {"K1"}),
    "staged quad -p 0": ((4096, 8192), 2.0, "SINGLE", "AUTO", True, "planes", {"K1"}),
    "staged quad woven upscale() -p 2": ((4096, 8192), 2.0, "HALF", "AUTO", True, "woven",
                                         {"K1"}),
    "staged quad 8640 -p 2": ((4320, 8640), 2.0, "HALF", "AUTO", True, "planes", {"K1"}),
    "big grid u=3 -p 2": ((2160, 3840), 3.0, "HALF", "AUTO", True, "planes", {"K4"}),
    "big c2c u=2 -p 2": ((4096, 8192), 2.0, "HALF", "AUTO", False, "planes", {"K1"}),
    "xla -p 0": ((4096, 8192), 2.0, "SINGLE", "XLA", True, "woven", {"K3"}),
    "fp64 staged64": ((1024, 2048), 2.0, "DOUBLE", "AUTO", True, "woven", set()),
    "fp64 grid64": ((720, 1280), 3.0, "DOUBLE", "AUTO", True, "woven", set()),
    "fp64 c2cgrid64": ((720, 1280), 3.0, "DOUBLE", "AUTO", False, "woven", set()),
    "fp64 8K": ((4096, 8192), 2.0, "DOUBLE", "AUTO", True, "woven", set()),
    "capacity xla -p 0": ((8192, 16384), 2.0, "SINGLE", "XLA", True, "woven", {"K3"}),
    "capacity staged quad -p 2": ((8192, 16384), 2.0, "HALF", "AUTO", True, "planes", {"K1"}),
}
# the big frames' fp64 oracles, computed in worker processes beside phases
# 3-5 (each takes 40-105 s of numpy on the card machine); the capacity frame
# is held against the reference tier on the card instead (its oracle takes
# minutes)
BIG_ORACLES = [(4096, 8192, 2.0, True), (4320, 8640, 2.0, True), (2160, 3840, 3.0, True),
               (4096, 8192, 2.0, False)]
ORACLE_WORKERS = 4
BIG_CLI_FRAME = (512, 4320)  # -u 2 -> 1024x8640: just over the cap, not 128-aligned


def seeded_image(h: int, w: int):
    """The smoke run's seeded (h, w, C) uint8 frame."""
    import numpy as np

    return np.random.default_rng(SEED + h + w).integers(0, 256, (h, w, C), np.uint8)


def oracle_job(h: int, w: int, u: float, r2c: bool):
    """The fp64 oracle of a seeded frame, in a worker process."""
    sys.path.insert(0, ROOT)
    from vkresample_tpu_torch.core.plan import UpscalePlan
    from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle

    t0 = time.perf_counter()
    out = upscale_oracle(seeded_image(h, w), UpscalePlan(h=h, w=w, upscale=u, r2c=r2c))
    return out, time.perf_counter() - t0


def dev_diff(got, want):
    """(max |diff|, share identical) of matching uint8 tensors on the card."""
    import torch

    d = max(int((g.to(torch.int16) - w.to(torch.int16)).abs().max()) for g, w in zip(got, want))
    same = sum(int((g == w).sum()) for g, w in zip(got, want)) / sum(g.numel() for g in got)
    return d, same


def big_phase(dev, card, oracles, launches_of, zero_counters):
    """Phase 8: the big tier (axes beyond the 8192 dense cap) and fp64
    through the user's entry points; for each run ms/frame, peak device
    memory, the launches of each kernel and the bank build time, cold and
    from the disk cache; each against the fp64 oracle (`oracles`, the big
    frames' among them)."""
    import shutil

    import torch

    from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale, upscale
    from vkresample_tpu_torch.core import bankcache
    from vkresample_tpu_torch.fft import mxu_pipeline
    from vkresample_tpu_torch.io.png import write_png
    from vkresample_tpu_torch.ops.weave import weave_grid_u8
    from vkresample_tpu_torch.pipeline.timing import time_amortized
    from vkresample_tpu_torch.pipeline.upscale import planes_format, route_engine

    # a bank cache of the smoke run's own, empty, so the cold builds are cold
    cache = os.path.join(ROOT, "vkresample_tpu_torch", "build", "smoke", "bankcache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["VKRESAMPLE_CACHE_DIR"] = cache
    gb = 1024 ** 3
    outs = {}
    for run, ((h, w), u, prec, engine, r2c, entry, runs) in BIG.items():
        plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec], r2c=r2c,
                           engine=Engine[engine])
        img = seeded_image(h, w)
        x = torch.from_numpy(img).to(dev)
        banks = "no banks (reference tier)"
        if route_engine(plan) is Engine.MXU:
            t0 = time.perf_counter()
            mxu_pipeline.make_dense_banks(plan)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            mxu_pipeline.make_dense_banks(plan)
            again = ("from the disk cache" if max(h, w, plan.H, plan.W) >= bankcache.MIN_CACHED_DIM
                     else "built again (below the cache's size gate)")
            banks = (f"bank set {mxu_pipeline.bank_set(plan)} built in {cold:.3f} s cold, "
                     f"{time.perf_counter() - t0:.3f} s {again}")
        fmt = planes_format(plan) if entry == "planes" else None
        require(entry == "woven" or fmt is not None, f"{run}: no parity planes")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        zero_counters()
        t0 = time.perf_counter()
        if entry == "planes":
            fn = build_upscale(plan, dev, planes_out=True)
            out = fn(x)
        else:
            out = upscale(x, u, plan=plan, device=dev)
            fn = build_upscale(plan, dev)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        counts = launches_of(run, runs)
        n = 1 if run.startswith("capacity") else 3
        _, ms = time_amortized(fn, (x,), n, dev)
        timing = f"{ms:.4f} ms/frame (-n {n} after a warm-up, CUDA events)"
        got = (weave_grid_u8(out, int(round(len(out) ** 0.5))).movedim(-3, -1)
               if fmt else out)
        require(tuple(got.shape) == (plan.H, plan.W, C) and got.dtype == torch.uint8,
                f"{run}: bad output {tuple(got.shape)} {got.dtype}")
        if run == "capacity staged quad -p 2":
            against, want = "the reference tier on the card", outs.pop("capacity xla -p 0")
        elif run == "capacity xla -p 0":
            outs[run] = got
            against, want = None, None
        else:
            against = "the fp64 oracle"
            want = torch.from_numpy(oracles[(h, w, u, r2c)]).to(dev)
        vs = ""
        if want is not None:
            d, same = dev_diff([got], [want])
            vs = f"; max|diff| vs {against} {d} LSB, identical {same:.6f}"
            require(d <= TOL_LSB, f"{run} is {d} LSB from {against}")
        print(f"[8 big] {run} ({fmt or 'woven'}): {w}x{h} -> {plan.W}x{plan.H}: {timing}; "
              f"first frame {first:.3f} s; peak device memory {peak / gb:.3f} GB "
              f"({(peak - held) / gb:.3f} GB above the {held / gb:.3f} GB held); {banks}; "
              f"launches {counts}{vs} on {card}")
        del out, got, want, fn, x

    # the CLI at a frame just over the cap, -validate, -p 2 and -p 1
    h, w = BIG_CLI_FRAME
    src = os.path.join(ROOT, "vkresample_tpu_torch", "build", "smoke", f"big_{w}x{h}.png")
    write_png(src, seeded_image(h, w))
    for prec in ("2", "1"):
        out = src.replace(".png", f"_p{prec}_out.png")
        cmd = [sys.executable, "-m", "vkresample_tpu_torch", "-i", src, "-o", out, "-u", "2",
               "-p", prec, "-validate"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"[8 big] cli {w}x{h} -u 2 -p {prec}: {line}")
        require(proc.returncode == 0 and "(tol 1) OK" in proc.stdout,
                f"CLI {w}x{h} -p {prec} exited {proc.returncode}: {proc.stderr[-2000:]}")
    shutil.rmtree(cache, ignore_errors=True)
    print(f"[8 big] bank cache {bankcache.cache_dir()} cleared")


# phase 9, the engine surface: case -> (operation, input shape, kernel,
# engine), seeded f32 inputs at full width, held against float64 np.fft on
# the host; twins that differ only in the engine share inputs and reference
ENGINE = {
    "conv gaussian auto (3, 1024, 2048)": ("conv", (3, 1024, 2048), "gaussian", "auto"),
    "conv gaussian mxu (3, 1024, 2048)": ("conv", (3, 1024, 2048), "gaussian", "mxu"),
    "conv gaussian auto (4096, 4096)": ("conv", (4096, 4096), "gaussian", "auto"),
    "conv random auto (3, 1024, 2048)": ("conv", (3, 1024, 2048), "random", "auto"),
    "conv random auto (4096, 4096)": ("conv", (4096, 4096), "random", "auto"),
    "conv bank of 4 auto (3, 1024, 2048)": ("conv", (3, 1024, 2048), "bank4", "auto"),
    "matrix 3x3 auto (3, 1024, 2048)": ("matrix", (3, 1024, 2048), "matrix3", "auto"),
    "linear 31x31 auto (3, 1080, 1920)": ("linear", (3, 1080, 1920), "random31", "auto"),
    "fftn forward (256, 256, 256)": ("fftn", (256, 256, 256), None, None),
    "fftn inverse (256, 256, 256)": ("ifftn", (256, 256, 256), None, None),
    "rfftn -> irfftn (256, 256, 256)": ("rfft", (256, 256, 256), None, None),
    "rfftn -> irfftn (64, 96, 135)": ("rfft", (64, 96, 135), None, None),
}
ENGINE_SIGMA = 2.5
ENGINE_TOL = 1e-5  # max|got - want| <= ENGINE_TOL * max|want|
ENGINE_CALLS = 20
PROFILE_PAIRS = 3  # flagship CLI runs without and with -profile, alternated
PROFILE_TRACE_KERNEL = "cas_grid_kernel<2"  # K1: cas_grid.cu's U = 2 instance


def engine_inputs(op: str, shape, kernel):
    """The seeded inputs (x, k) of a phase-9 case, numpy f32; x is an (re,
    im) pair for the complex transforms."""
    import zlib

    import numpy as np

    from vkresample_tpu_torch.ops.convolve import gaussian_kernel

    rng = np.random.default_rng(SEED + zlib.crc32(repr((op, shape, kernel)).encode()))
    if op in ("fftn", "ifftn"):
        return tuple(rng.standard_normal(shape, np.float32) for _ in range(2)), None
    x = rng.standard_normal(shape, np.float32)
    h, w = shape[-2:]
    k = {
        None: None,
        "gaussian": lambda: gaussian_kernel(h, w, ENGINE_SIGMA),
        "random": lambda: rng.standard_normal((h, w), np.float32) / np.float32((h * w) ** 0.5),
        "bank4": lambda: rng.standard_normal((4, h, w), np.float32) / np.float32((h * w) ** 0.5),
        "matrix3": lambda: rng.standard_normal((3, 3, h, w), np.float32)
        / np.float32((3 * h * w) ** 0.5),
        "random31": lambda: rng.standard_normal((31, 31), np.float32) / np.float32(31),
    }[kernel]
    return x, (k() if k else None)


def engine_reference(op: str, shape, kernel):
    """(float64 np.fft result of a phase-9 case, host seconds), in a worker
    process; rfft cases give (rfftn spectrum, its irfftn)."""
    sys.path.insert(0, ROOT)
    import numpy as np

    t0 = time.perf_counter()
    x, k = engine_inputs(op, shape, kernel)
    if op == "fftn":
        return np.fft.fftn(x[0] + 1j * x[1].astype(np.float64)), time.perf_counter() - t0
    if op == "ifftn":
        return np.fft.ifftn(x[0] + 1j * x[1].astype(np.float64)), time.perf_counter() - t0
    x = x.astype(np.float64)
    if op == "rfft":
        F = np.fft.rfftn(x)
        return (F, np.fft.irfftn(F, s=shape)), time.perf_counter() - t0
    k = k.astype(np.float64)
    if op == "linear":
        s = (shape[-2] + k.shape[-2] - 1, shape[-1] + k.shape[-1] - 1)
        want = np.fft.irfft2(np.fft.rfft2(x, s) * np.fft.rfft2(k, s), s)
        return want, time.perf_counter() - t0
    s = shape[-2:]
    X, K = np.fft.rfft2(x), np.fft.rfft2(k)
    if op == "matrix":
        Y = np.einsum("oihw,ihw->ohw", K, X)
    elif k.ndim == 3:  # a bank: the output gains a leading K axis
        Y = K[:, None] * X[None]
    else:
        Y = X * K
    return np.fft.irfft2(Y, s), time.perf_counter() - t0


def engine_phase(dev, card, engine_jobs, launches_of, zero_counters):
    """Phase 9: the engine surface (ops/convolve.py, fft/ndim.py) at full
    width through its entry points, each case against float64 np.fft
    (computed in worker processes beside phases 6-8), ms per call; then the
    flagship CLI in alternating pairs without and with -profile, whose
    torch.profiler traces must parse and name K1's kernel and a GEMM."""
    import glob
    import shutil

    import numpy as np
    import torch

    from vkresample_tpu_torch.fft.ndim import fftn, irfftn, rfftn
    from vkresample_tpu_torch.io.png import write_png
    from vkresample_tpu_torch.ops import convolve as conv_mod

    for case, (op, shape, kernel, engine) in ENGINE.items():
        x, k = engine_inputs(op, shape, kernel)
        if op in ("fftn", "ifftn"):
            pair = tuple(torch.from_numpy(v).to(dev) for v in x)
            call = lambda: fftn(pair, axes=(0, 1, 2), inverse=op == "ifftn", device=dev)
        elif op == "rfft":
            xd = torch.from_numpy(x).to(dev)

            def call():
                F = rfftn(xd, axes=(0, 1, 2), device=dev)
                return F, irfftn(F, s=shape, axes=(0, 1, 2), device=dev)
        else:
            xd = torch.from_numpy(x).to(dev)
            # the Gaussian as a user makes it, on the host; the random
            # kernels on the card
            kd = k if kernel == "gaussian" else torch.from_numpy(k).to(dev)
            fn = {"conv": conv_mod.fft_convolve2d, "matrix": conv_mod.fft_matrix_convolve2d,
                  "linear": conv_mod.fft_convolve2d_linear}[op]
            call = lambda: fn(xd, kd, engine=engine, device=dev)
        zero_counters()
        got = call()
        torch.cuda.synchronize()
        launches_of(case, set())
        want, ref_secs = engine_jobs[(op, shape, kernel)].result()
        parts = (((got[0][0], got[0][1]), want[0]), (got[1], want[1])) if op == "rfft" \
            else ((got, want),)
        ratios = []
        for g, w in parts:
            g = (g[0].double() + 1j * g[1].double()) if isinstance(g, tuple) else g.double()
            require(tuple(g.shape) == w.shape, f"{case}: shape {tuple(g.shape)} vs {w.shape}")
            g = g.cpu().numpy()
            require(bool(np.all(np.isfinite(g))), f"{case}: non-finite output")
            ratios.append(float(np.abs(g - w).max() / np.abs(w).max()))
        del got, parts, g
        ms = cuda_ms(call, ENGINE_CALLS)
        print(f"[9 engine] {case}: max|got - want| / max|want| "
              f"{', '.join(f'{r:.3e}' for r in ratios)} (tol {ENGINE_TOL:g}; float64 np.fft "
              f"in {ref_secs:.3f} s on the host); {ms:.4f} ms/call ({ENGINE_CALLS} calls "
              f"after a warm-up, CUDA events) on {card}")
        require(max(ratios) <= ENGINE_TOL, f"{case}: error ratio {max(ratios):.3e}")
        del call, want
        torch.cuda.empty_cache()

    # the flagship CLI, without and with -profile in alternating pairs (the
    # second pair reversed, and so on) for the profiler's cost on the
    # Time: line; each traced run writes its own directory
    out_dir = os.path.join(ROOT, "vkresample_tpu_torch", "build", "smoke")
    trace_root = os.path.join(out_dir, "profile")
    shutil.rmtree(trace_root, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "profile_2048x1024.png")
    write_png(src, seeded_image(1024, 2048))
    argv = ["-i", src, "-o", src.replace(".png", "_out.png"), "-u", "2", "-p", "2", "-n", "5"]
    times = {"cli": [], "cli -profile": []}
    traces = []
    for i in range(PROFILE_PAIRS):
        order = ("cli", "cli -profile") if i % 2 == 0 else ("cli -profile", "cli")
        for label in order:
            trace_dir = os.path.join(trace_root, str(i))
            zero_counters()
            rc, lines = run_cli(argv + (["-profile", trace_dir] if "profile" in label else []))
            for line in lines:
                print(f"[9 engine] {label} (pair {i}): {line}")
            t = [float(line.split(" Time: ")[1].split()[0]) for line in lines if " Time: " in line]
            require(rc == 0 and t, f"{label} exited {rc} or printed no Time: line")
            times[label] += t
            launches_of(f"{label} (pair {i})", {"K1"})
        found = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        require(len(found) == 1, f"-profile wrote {found}")
        traces += found
    print(f"[9 engine] the flagship -u 2 -p 2 -n 5, Time: ms in run order, pairs alternated: "
          f"without -profile {times['cli']}, with it {times['cli -profile']}; medians "
          f"{float(np.median(times['cli'])):.3f} and {float(np.median(times['cli -profile'])):.3f}"
          f" on {card}")
    for n, trace in enumerate(traces):
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernel_us = {}
        for e in events:
            if e.get("cat") == "kernel":
                kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
        print(f"[9 engine] trace {os.path.relpath(trace, ROOT)}: "
              f"{os.path.getsize(trace)} bytes, {len(events)} events, "
              f"{len(kernel_us)} device kernels")
        if n == 0:
            for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:5]:
                print(f"[9 engine] trace top kernel {us / 1e3:.4f} ms (sum over the traced "
                      f"warm-up and -n 5 frames): {name[:140]}")
        require(any(PROFILE_TRACE_KERNEL in name for name in kernel_us),
                f"the -profile trace {trace} names no {PROFILE_TRACE_KERNEL} (K1)")
        require(any("gemm" in name.lower() for name in kernel_us),
                f"the -profile trace {trace} names no GEMM kernel")


# phase 10, the sp pencil mode: case -> (pencil form, (h, w), upscale,
# precision, r2c), seeded frames at full width, each through the builder a
# user calls on every rank; run at S = 1 over NCCL and at S = 2 and 4 as
# processes that share the one card over gloo
SP_CASES = {
    "rows -p 2": ("rows", (1024, 2048), 2.0, "HALF", True),
    "rows -p 0": ("rows", (1024, 2048), 2.0, "SINGLE", True),
    "dense -p 2": ("dense", (1024, 2048), 2.0, "HALF", True),
    "dense -p 0": ("dense", (1024, 2048), 2.0, "SINGLE", True),
    "staged -p 2": ("staged", (1024, 2048), 2.0, "HALF", True),
    "staged -p 0": ("staged", (1024, 2048), 2.0, "SINGLE", True),
    "grid u=3 -p 2": ("grid", (720, 1280), 3.0, "HALF", True),
    "grid u=3 -p 0": ("grid", (720, 1280), 3.0, "SINGLE", True),
    "c2c grid u=2 -p 2": ("c2c_grid", (1024, 2048), 2.0, "HALF", False),
    "c2c grid u=2 -p 0": ("c2c_grid", (1024, 2048), 2.0, "SINGLE", False),
}
# the column forms' shard blocks (H, W/S) of K3h: (output (H, W), shard
# counts, dtypes) for the flagship, the grid form's u=3 720p and the large
# frame
K3_SHARDS = (
    ((2048, 4096), (1, 2, 4), ("int16", "float32")),
    ((2160, 3840), (1, 2, 4), ("int16", "float32")),
    ((8192, 16384), (2,), ("int16",)),
)
# the large sp frame, at S = 2 only
SP_BIG = {"big staged -p 2": ("staged", (4096, 8192), 2.0, "HALF", True)}
SP_SHARDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
# the parent commit's device-alone readings of each form's shard CAS
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): K6's first design with
# gathered 64-row blocks (at S = 1: the A/B frame at bh = 64), and concat +
# K3 + crop at S = 1
PARENT_SHARD_CAS = {
    ("rows", 1): "0.2096-0.2107 ms", ("rows", 2): "0.1120-0.1126 ms",
    ("rows", 4): "0.0649-0.0651 ms",
    ("cols", 2048, 4096, 1, "torch.int16"): "0.2217 ms",
    ("cols", 2048, 4096, 1, "torch.float32"): "0.2325 ms",
}
SP_ITERS = 5
SP_TIMEOUT_S = 300
DP_FRAMES = 8


def sp_phase(dev, card, kernels, oracles, image, launches_of, zero_counters):
    """Phase 10: the sp pencil mode and dp batches.  Each form's shard CAS
    (K6's shard wrapper, K3h) against its plain version and the parent's
    form at the flagship's shard shapes, timed, one CAS kernel a call by
    torch.profiler; every sp case on S ranks (one spawn per S, every case
    in it), each gathered frame within 1 LSB of the fp64 oracle and of the
    single-card upscale(), K6 launched once per frame on every rank of the
    rows form and K3h once on the others; ms/frame per rank, the
    collectives' share, peak device memory per rank; then a dp batch over
    [cuda:0, cuda:0] against the one-device calls."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vkresample_tpu_torch import (Engine, Precision, UpscalePlan, build_batched_upscale,
                                      upscale)
    from vkresample_tpu_torch.ops import cas_cuda
    from vkresample_tpu_torch.ops.cas import to_i16_storage
    from vkresample_tpu_torch.parallel.distributed import OUTPUT_AXIS, gather_blocks
    from vkresample_tpu_torch.parallel.launch import spawn
    from vkresample_tpu_torch.parallel.mesh import split_frames
    from vkresample_tpu_torch.parallel.sp_run import sp_frames

    t_phase = time.perf_counter()
    gb = 1024 ** 3
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    # the shard CAS of each form as _cas_rows and _cas_cols run it once the
    # halos are in: K6's shard wrapper on the rows form's shards of the
    # flagship's output (the shard one block), the column-halo K3 on the
    # column forms' blocks, with random halos (not the image's own rows or
    # columns, so a kernel that ignored them would differ); beside each the
    # parent's form on this run's kernels (K6 on 64-row blocks with gathered
    # halo rows; concat + K3 + crop), the parent's own readings, K3 alone
    # on the block and the bound; torch.profiler lists the device kernels
    # of one call: one CAS kernel, no copy of the shard
    def one_cas_kernel(what, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        found = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        require(list(found.values()) == [1] and "cas_rows_kernel" in next(iter(found)),
                f"{what}: device kernels and copies {found}, expected one cas_rows_kernel")
        return next(iter(found))

    def rand(shape, dt):
        v = torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1
        return to_i16_storage(v) if dt == torch.int16 else v

    for S in (1, 2, 4):
        r = 2048 // S
        v, top, bot = rand((C, r, 4096), torch.float32), *(rand((C, 1, 4096), torch.float32)
                                                           for _ in range(2))
        shard_cas = lambda: cas_cuda.cas_quantize_blocked_halo(v, top, bot, 0.2)  # noqa: E731

        def parent_form():
            htop, hbot = cas_cuda.blocked_halo_rows(v, 64)
            htop[:, :1], hbot[:, -1:] = top, bot
            return cas_cuda.cas_quantize_blocked_rows(v, htop, hbot, 64, 0.2)

        got = shard_cas()
        d, _ = dev_diff([got], [cas_cuda.cas_quantize_blocked_reference(v, top, bot, r, 0.2)])
        d_parent, _ = dev_diff([got], [parent_form()])
        kernel = one_cas_kernel(f"K6's shard wrapper at S = {S}", shard_cas)
        bound_ms, bound_by = halo_bound((v, top, bot))
        alone = graph_ms(shard_cas, 50)
        print(f"[10 sp] K6 cas_quantize_blocked_halo {tuple(v.shape)} (the rows form's S = {S} "
              f"shard of the flagship's output, one block, random halo rows): max|diff| vs its "
              f"plain version {d} LSB, vs the parent's form {d_parent} LSB; eager "
              f"{cuda_ms(shard_cas, 50):.4f} ms, on the device alone {alone:.4f} ms (parent's "
              f"reading {PARENT_SHARD_CAS[('rows', S)]}; the parent's form on this kernel "
              f"{graph_ms(parent_form, 50):.4f}; K3 alone on the shard "
              f"{graph_ms(lambda: cas_cuda.cas_quantize(v, 0.2), 50):.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / alone:.0%} of it); profiler: one "
              f"launch of {kernel[:90]}, no other device kernel or copy; {card}")
        require(d == 0 and d_parent == 0, f"K6's shard wrapper at S = {S} differs: {d}, "
                f"{d_parent} LSB from its plain version and the parent's form")
        kernels["K6"]["max_abs_err"] = max(kernels["K6"]["max_abs_err"], d)
    del v, top, bot, got

    for (H, W), shards, dts in K3_SHARDS:
        for S in shards:
            for dt in (getattr(torch, name) for name in dts):
                v, left, right = rand((C, H, W // S), dt), rand((C, H, 1), dt), rand((C, H, 1), dt)
                shard_cas = lambda: cas_cuda.cas_quantize_cols_halo(  # noqa: E731
                    v, left, right, 0.2)
                parent_form = lambda: cas_cuda.cas_quantize(  # noqa: E731
                    torch.cat([left, v, right], -1), 0.2)[..., 1:-1].contiguous()
                d, _ = dev_diff([shard_cas()], [parent_form()])
                kernel = one_cas_kernel(f"the column forms' shard CAS S = {S} {dt}", shard_cas)
                bound_ms, bound_by = halo_bound((v, left, right))
                alone = graph_ms(shard_cas, 50)
                parent = PARENT_SHARD_CAS.get(("cols", H, W, S, str(dt)), "not read")
                print(f"[10 sp] K3h cas_quantize_cols_halo {tuple(v.shape)} {dt} (the column "
                      f"forms' S = {S} shard CAS, random halo columns): max|diff| vs the "
                      f"parent's form (concat + K3 + crop) {d} LSB; eager "
                      f"{cuda_ms(shard_cas, 50):.4f} ms, on the device alone {alone:.4f} ms "
                      f"(parent's reading {parent}; the parent's form on this run's K3 "
                      f"{graph_ms(parent_form, 50):.4f}; K3 alone on the block "
                      f"{graph_ms(lambda: cas_cuda.cas_quantize(v, 0.2), 50):.4f}), bound "
                      f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / alone:.0%} of it); profiler: "
                      f"one launch of {kernel[:90]}, no other device kernel or copy; {card}")
                require(d == 0, f"the column forms' shard CAS at S = {S} {dt} differs from "
                        f"the parent's form by {d} LSB")
                kernels["K3h"]["max_abs_err"] = max(kernels["K3h"]["max_abs_err"], d)
                del v, left, right
        torch.cuda.empty_cache()

    def plan_of(form, hw, u, prec, r2c):
        return UpscalePlan(h=hw[0], w=hw[1], upscale=u, precision=Precision[prec], r2c=r2c,
                           engine=Engine.MXU)

    # the single card's peak at the large frame, beside each rank's below
    _, hw, u, _, _ = SP_BIG["big staged -p 2"]
    big_plan = plan_of(*SP_BIG["big staged -p 2"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # the single-card outputs each gathered frame is held against
    singles = {"big staged -p 2": upscale(image(*hw), u, plan=big_plan, device=dev).cpu()}
    torch.cuda.synchronize()
    big_single_peak = torch.cuda.max_memory_allocated(dev) - held
    print(f"[10 sp] big staged -p 2 {hw[1]}x{hw[0]} -> {big_plan.W}x{big_plan.H} on one card, "
          f"upscale(): peak device memory {big_single_peak / gb:.3f} GB above the "
          f"{held / gb:.3f} GB held on {card}")
    torch.cuda.empty_cache()

    # every case on S ranks: one spawn per S
    for S, backend in SP_SHARDS:
        names = list(SP_CASES) + (list(SP_BIG) if S == 2 else [])
        specs = {**SP_CASES, **SP_BIG}
        cases = [(specs[n][0], plan_of(*specs[n]), image(*specs[n][1])) for n in names]
        label = ("one card, NCCL, one rank" if backend == "nccl" else
                 f"one card shared by {S} ranks, gloo through host, not a multi-card speed")
        t0 = time.perf_counter()
        ranks = spawn(S, sp_frames, (cases, None, SP_ITERS), backend=backend,
                      timeout_s=SP_TIMEOUT_S)
        print(f"[10 sp] S = {S} over {backend}: {len(names)} cases on {S} ranks in "
              f"{time.perf_counter() - t0:.3f} s (one spawn)")
        for i, name in enumerate(names):
            form, hw, u, prec, r2c = specs[name]
            plan = cases[i][1]
            recs = [r[i] for r in ranks]
            kid = "K6" if form == "rows" else "K3h"
            for rank, rec in enumerate(recs):
                require(rec["launches"] == {"K3": 0, "K3h": 0, "K6": 0} | {kid: 1},
                        f"sp {name} S = {S} rank {rank}: launches {rec['launches']}, "
                        f"expected {kid} once")
            kernels[kid]["launches"] += S
            got = torch.from_numpy(gather_blocks([r["block"] for r in recs], OUTPUT_AXIS[form]))
            require(tuple(got.shape) == (plan.H, plan.W, C), f"sp {name} S = {S}: shape "
                    f"{tuple(got.shape)}")
            key = (hw[0], hw[1], u, r2c)
            d_or, same_or = dev_diff([got.to(dev)], [torch.from_numpy(oracles[key]).to(dev)])
            if name not in singles:
                singles[name] = upscale(image(*hw), u, plan=plan, device=dev).cpu()
            d_one, same_one = dev_diff([got.to(dev)], [singles[name].to(dev)])
            ms = ", ".join(f"{r['ms']:.4f}" for r in recs)
            share = ", ".join(f"{r['collective_share']:.3f}" for r in recs)
            peak = ", ".join(f"{r['peak_bytes'] / gb:.3f}" for r in recs)
            print(f"[10 sp] {name} {hw[1]}x{hw[0]} -> {plan.W}x{plan.H} S = {S} ({backend}): "
                  f"max|diff| vs the fp64 oracle {d_or} LSB (identical {same_or:.6f}), vs the "
                  f"single-card upscale() {d_one} LSB (identical {same_one:.6f}); {kid} once "
                  f"per frame on each rank; ms/frame per rank [{ms}] (-n {SP_ITERS}, CUDA "
                  f"events); share in collectives per rank [{share}]; peak device memory per "
                  f"rank [{peak}] GB" + (f" (one card: {big_single_peak / gb:.3f} GB)"
                                         if name in SP_BIG else "")
                  + f"; {label}; {card}")
            require(d_or <= TOL_LSB and d_one <= TOL_LSB,
                    f"sp {name} S = {S}: {d_or} LSB from the oracle, {d_one} from upscale()")
            del got
        del ranks
        torch.cuda.empty_cache()

    # dp: a batch split over [cuda:0, cuda:0]; each device's share against
    # the one-device call on the same frames (identical), the whole against
    # the one-device batch of all of them (cuBLAS picks its GEMM tiles by
    # the batch's size, so that is within 1 LSB, as in phase 7)
    plan = UpscalePlan(h=1024, w=2048, upscale=2.0, precision=Precision.HALF)
    frames = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, 256, (DP_FRAMES, 1024, 2048, C), np.uint8))
    # the first frame of each device's share is the flagship's seeded
    # image, whose fp64 oracle the dp output is also held against
    with_oracle = (0, DP_FRAMES // 2)
    for i in with_oracle:
        frames[i] = torch.from_numpy(image(1024, 2048))
    one = build_batched_upscale(plan, dev, planes_out=True)
    shares = [one(frames[s].to(dev)) for s in split_frames(DP_FRAMES, [dev, dev])]
    whole = one(frames.to(dev))
    zero_counters()
    two = build_batched_upscale(plan, [dev, dev], planes_out=True)(frames)
    torch.cuda.synchronize()
    counts = launches_of("dp quad -p 2", {"K1"})
    require(counts["K1"] == 2, f"dp: K1 launched {counts['K1']} times, expected once a device")
    d_share = max(dev_diff(part, share)[0] for part, share in zip(two, shares))
    d_whole, same = dev_diff([torch.cat([part[i] for part in two]) for i in range(4)], whole)
    print(f"[10 dp] quad -p 2 {DP_FRAMES} x 2048x1024 over [{dev}, {dev}]: max|diff| vs the "
          f"one-device call on each device's frames {d_share} LSB; vs the one-device batch of "
          f"all {DP_FRAMES} {d_whole} LSB (identical {same:.6f}); K1 once per device "
          f"({counts['K1']} launches) on {card}")
    require(d_share == 0 and d_whole <= TOL_LSB, "dp batch differs from the one-device calls")
    per = DP_FRAMES // 2
    d_or = max(int(np.abs(woven_hwc([p[i % per] for p in two[i // per]], "quad", plan)
                          .astype(np.int16) - oracles[(1024, 2048, 2.0, True)]).max())
               for i in with_oracle)
    print(f"[10 dp] quad -p 2 over [{dev}, {dev}]: frames {with_oracle} (the flagship image, "
          f"the first of each device's share) max|diff| vs the fp64 oracle {d_or} LSB on {card}")
    require(d_or <= TOL_LSB, f"dp output {d_or} LSB from the fp64 oracle")
    print(f"[10 sp] phase 10 in {time.perf_counter() - t_phase:.3f} s")


def main() -> int:
    """Phases 1-10, with the big frames' oracles and the engine cases'
    float64 references in worker processes that are stopped before it
    returns or raises."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    sys.path.insert(0, ROOT)
    import torch

    require(torch.cuda.is_available(), "no CUDA device: the smoke run needs one GPU")
    pool = ProcessPoolExecutor(ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run(pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(pool) -> int:
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
    from vkresample_tpu_torch.pipeline.upscale import (
        _pipeline,
        fp32_matmul,
        make_device_banks,
        planes_format,
    )

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
        """(U, T2, YT) of case ((c, h, W), r) or ((c, h, W), r, "misaligned")
        for a U 2 or 4 bytes past a 16-byte boundary: r None = the frame's
        own y bank, else a random bank with r correction rows."""
        (c, h, W), r = case[:2]
        if r is None:
            YT = ybank(h, W // 2)
        else:
            YT = torch.randn((h, h + r), generator=gen, device=dev) * (0.6 / (h + r) ** 0.5)
        r = YT.shape[1] - h
        T2 = torch.rand((c, r, W), generator=gen, device=dev) * 0.1 - 0.05 if r else None
        U = planes((c, h, W), 1, dt)[0]
        return (misaligned(U) if len(case) > 2 else U), T2, YT

    def ycas_gemm(U, T2, YT):
        """The unfused form's y GEMM: torch.matmul (cuBLAS) in full fp32."""
        with fp32_matmul():
            return ycas_cuda.ycas_odd_rows_reference(U, T2, YT)[1]

    def ycas_unfused(U, T2, YT, sharpen):
        """The unfused form of K8: the cuBLAS y GEMM (O stored as Q2.14 in
        -p 2, as the rows route does) + K2."""
        O = ycas_gemm(U, T2, YT)
        return cas_cuda.cas_parity_planes_u2(U, to_i16_storage(O) if U.dtype == torch.int16
                                             else O, sharpen)

    # K8 and K9: the route shapes with their frames' y banks, then the 128 x
    # 128 tile's band edges (h = 127, 128, 129, 255) and strip edges (W =
    # 126, 127, 128, 129, 257; W % 8 != 0 stages int16 per element), K = h +
    # r on and off multiples of 8 and 32 with r = 0, 1, 2, 4, U 2 or 4 bytes
    # past a 16-byte boundary, single rows and columns
    ycas_edges = (
        [((2, 37, 200), 0), ((2, 37, 200), 2), ((2, 1, 200), 1), ((2, 1, 200), 0)]
        + [((2, h, 200), r) for h, r in ((127, 0), (128, 1), (129, 2), (255, 1))]
        + [((2, 40, W), r) for W, r in ((126, 1), (127, 0), (128, 2), (129, 1), (257, 1))]
        + [((2, 124, 256), 4), ((2, 126, 384), 2)]
        + [((2, 130, 264), 1, "misaligned"), ((C, 1080, 2880), None, "misaligned"),
           ((2, 37, 200), 2, "misaligned")]
        + [((2, 1, 1), 0), ((2, 1, 1), 2), ((2, 300, 1), 1)])

    def blocked_args(case, dt):
        """(v, top, bot, bh): K6's arguments, v and random halo rows (not
        v's own rows, so a kernel that ignored them would differ)."""
        (c, H, W), bh = case
        v, top, bot = planes((c, H, W), 1, dt) + planes((c, -(-H // bh), W), 2, dt)
        return v, top, bot, bh

    def cols_halo_args(case, dt):
        """(v, left, right): K3h's arguments, v and random halo columns."""
        c, H, W = case
        return tuple(planes((c, H, W), 1, dt) + planes((c, H, 1), 2, dt))

    # the batched path's plane counts (frames x channels in one launch):
    # phase 7's N = 3 frames, then the folder CLI's -batch 8 and its tail of 4
    batch_planes = [n * C for n in (BATCH_N, 8, FOLDER_FRAMES - 8)]

    k3_same = ("K3", lambda v, bh, s: cas_cuda.cas_quantize(v, s))  # K7's yardstick

    # K7 and K10b (csrc/stream_pipeline.cuh): the A/B frame at bh 128 and 64
    # (both timed), K3's route shape, then the pipeline's edges: bh 1, 7, 32,
    # 128, 1000 and past H, a partial last strip with W % 4 == 0 (4100) and
    # W % 4 != 0 (4097), H = 1, W = 1, H one row past a segment multiple,
    # the folder CLI's batch of 8 x 3 planes, and views one float off a
    # 16-byte boundary (the per-element copy form, also at the A/B frame)
    mono_cases = (
        [((C, 2048, 4096), 128), ((C, 2048, 4096), 64), ((C, 2160, 3840), 128)]
        + [((2, 37, 201), bh) for bh in (1, 7, 32, 128, 1000)]
        + [((2, 64, 4100), 32), ((2, 33, 4097), 7), ((1, 1, 1), 1), ((1, 1, 1), 5),
           ((C, 1, 4096), 3), ((2, 300, 1), 1), ((2, 129, 256), 128), ((2, 129, 256), 64),
           ((2, 65, 4096), 64), ((batch_planes[1], 512, 1024), 128)]
        + [((2, 37, 200), 7, "misaligned"), ((C, 2048, 4096), 64, "misaligned")])

    def mono_args(case, dt):
        """(v, bh) of a K7 or K10b case (shape, bh), or (shape, bh,
        "misaligned") for a v one element past a 16-byte boundary."""
        v = planes(case[0], 1, dt)[0]
        return (misaligned(v) if len(case) > 2 else v), case[1]

    def quant_bound(v):
        """A copy-quantize probe reads v once and writes as many uint8."""
        return bound(v.numel() * 5, v.numel() * QUANT_OPS_PER_PIXEL)

    def k5_unfused(U, O, u, s):
        """The unfused form K5 replaces: weave_rows + K3."""
        return cas_cuda.cas_quantize(dense.weave_rows(U, O, u), s)

    # kernel id -> name, wrapper (fn unless given: the function whose launch
    # counter is read), kernel call, plain version, sources, argument cases
    # (the first is the route shape, timed in phase 6; the batched path's
    # shapes last, each route shape with N = 3 frames in its planes, K1 also
    # with the CLI's 8 and 4), dtypes (int16 and
    # f32 unless given), argument maker, bound from the arguments; exact:
    # identical to the plain version on every pixel; vs: (label, form, max
    # LSB) it is held against in phase 3 (not when max LSB is None) and
    # timed beside in phase 6 unless it is the unfused form; unfused: the
    # unfused form it replaces, timed in phase 6; timed: how many of the
    # first cases phase 6 times (1 unless given); beside: (label, form) whose
    # device time alone phase 6 prints beside the kernel's, with its bound
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
            + [((2, 21, 136), "misaligned"), ((C, 1024, 2048), "misaligned")]
            + [(n, 1024, 2048) for n in batch_planes] + [((batch_planes[0], 1024, 2048),
                                                          "misaligned")],
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
            + [((2, 37, 200), "misaligned"), ((C, 1080, 2880), "misaligned")]
            + [(batch_planes[0], 1080, 2880), ((batch_planes[0], 1080, 2880), "misaligned")],
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
            + [((2, 37, 200), "misaligned"), ((C, 2160, 3840), "misaligned")]
            + [(batch_planes[0], 1080, 1920)],
            args=lambda case, dt: image_args(case, dt, 1),
            bound=lambda a: cas_bound(a[0].shape, 1, a[0].element_size()),
            exact=True,
        ),
        "K3h": dict(
            name="cas_quantize_cols_halo", fn=cas_cuda.cas_quantize_cols_halo,
            plain=cas_cuda.cas_quantize_cols_halo_reference,
            source="vkresample_tpu_torch/csrc/cas_rows.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:543",
            # the sp column forms' shard blocks (W/S columns, one halo column
            # on each side by pointer) at S = 1, 2, 4, flagship and u=3 720p,
            # then W % 4 != 0, W % 8 != 0, H off the band, a single column
            # and a single pixel
            cases=[(C, H, W // S) for (H, W), shards, _ in K3_SHARDS[:2] for S in shards]
            + [(2, 37, 201), (2, 37, 200), (2, 65, 131), (2, 40, 1), (1, 1, 1)],
            args=cols_halo_args,
            bound=halo_bound,
            exact=True,
            vs=("K3 on the block", lambda v, left, right, s: cas_cuda.cas_quantize(v, s), None),
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
            + [((C, 540, 960), 4, "misaligned")]
            + [((batch_planes[0], 720, 1280), 3)],
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
               ((C, 540, 3840), 4, "misaligned")]
            + [((batch_planes[0], 720, 3840), 3)],
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
            fn=cas_cuda.cas_quantize_blocked_rows,
            plain=cas_cuda.cas_quantize_blocked_reference,
            source="vkresample_tpu_torch/csrc/cas_rows.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:2427",
            # the A/B frame at bh = 64, the sp rows form's flagship shards as
            # one block (S = 2, 4), K3's route shape and an odd one at bh 1,
            # 7 and 64, a ragged last block on the 16-byte staging, bh past
            # H and a single pixel
            cases=[((C, 2048, 4096), 64), ((C, 1024, 4096), 1024), ((C, 512, 4096), 512)]
            + [(shape, bh) for shape in ((C, 2160, 3840), (2, 37, 201)) for bh in (1, 7, 64)]
            + [((2, 130, 136), 100), ((2, 37, 201), 50), ((1, 1, 1), 1)],
            dtypes=(torch.float32,),
            args=blocked_args,
            bound=halo_bound,
            exact=True,
            vs=("K3", lambda v, top, bot, bh, s: cas_cuda.cas_quantize(v, s), None),
            timed=3,
        ),
        "K7": dict(
            name="cas_quantize_mono", wrapper=cas_cuda.cas_quantize_mono,
            fn=lambda v, bh, s: cas_cuda.cas_quantize_mono(v, s, bh),
            plain=lambda v, bh, s: cas_cuda.cas_quantize_mono_reference(v, s),
            source="vkresample_tpu_torch/csrc/cas_mono.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:2550",
            cases=mono_cases,
            dtypes=(torch.float32,),
            args=mono_args,
            bound=lambda a: cas_bound(a[0].shape, 1, 4),
            exact=True,
            vs=k3_same + (0,),
            beside=k3_same,
            timed=2,
        ),
        "K8": dict(
            name="ycas_parity_u2", fn=ycas_cuda.ycas_parity_u2,
            plain=ycas_cuda.ycas_parity_u2_reference,
            source="vkresample_tpu_torch/csrc/ycas.cu",
            replaces="vkresample_tpu/ops/ycas_pallas.py:406",
            cases=[((C, 1080, 2880), None), ((C, 1024, 4096), None)] + ycas_edges,
            args=ycas_args, bound=lambda a: ycas_bound(*a), unfused=ycas_unfused,
            timed=2,
        ),
        "K9": dict(
            name="ycas_u2", fn=ycas_cuda.ycas_u2, plain=ycas_cuda.ycas_u2_reference,
            source="vkresample_tpu_torch/csrc/ycas.cu",
            replaces="vkresample_tpu/ops/ycas_pallas.py:509",
            cases=[((C, 1024, 4096), None), ((C, 1080, 2880), None)] + ycas_edges,
            args=ycas_args, bound=lambda a: ycas_bound(*a),
            unfused=lambda *a: weave_rows_u8(*ycas_unfused(*a)),
            timed=2,
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
            cases=mono_cases,
            dtypes=(torch.float32,),
            args=mono_args,
            bound=lambda a: quant_bound(a[0]),
            exact=True,
            vs=("K7 at the same bh", lambda v, bh, s: cas_cuda.cas_quantize_mono(v, s, bh), None),
            beside=("K10c", lambda v, bh, s: quantize_cuda.copy_quantize_rows(v)),
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
    # the big frames' fp64 oracles (phase 8) run in worker processes beside
    # phases 3-5; phase 6, the times, starts once they are done
    big_jobs = {key: pool.submit(oracle_job, *key) for key in BIG_ORACLES}
    # phase 9's float64 references, queued behind them
    engine_jobs = {}
    for op, shape, kernel, _ in ENGINE.values():
        if (op, shape, kernel) not in engine_jobs:
            engine_jobs[(op, shape, kernel)] = pool.submit(engine_reference, op, shape, kernel)

    # 3. each kernel against its plain version at its routes' shapes
    for kid, k in kernels.items():
        k["max_abs_err"] = 0
        for case in k["cases"]:
            for dt in k.get("dtypes", (torch.float32, torch.int16)):
                args = k["args"](case, dt)
                got = call(k, "fn", args)
                bounded_sync(f"{kid} at {case}", KERNEL_TIMEOUT_S)
                d, same = u8_diff(got, call(k, "plain", args))
                form = getattr(k.get("wrapper", k["fn"]), "staging", None)  # K1-K3, K7, K10b
                print(f"[3 kernels] {kid} {k['name']} {case} {dt}: max|diff| {d} LSB, "
                      f"identical {same:.6f}" + (f"; staging {form}" if form else ""))
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

    # K8 and K9 are one template: on every case K9 is the woven K8, and each
    # wrapper call launches its kernel once
    for case in kernels["K8"]["cases"]:
        for dt in (torch.float32, torch.int16):
            args = ycas_args(case, dt)
            before = (ycas_cuda.ycas_parity_u2.launches, ycas_cuda.ycas_u2.launches)
            E, D = ycas_cuda.ycas_parity_u2(*args, 0.2)
            woven = ycas_cuda.ycas_u2(*args, 0.2)
            torch.cuda.synchronize()
            after = (ycas_cuda.ycas_parity_u2.launches, ycas_cuda.ycas_u2.launches)
            require(after == (before[0] + 1, before[1] + 1),
                    f"K8/K9 at {case}: launches {before} -> {after}")
            require(torch.equal(weave_rows_u8(E, D), woven), f"K9 is not the woven K8 at {case}")
    print(f"[3 kernels] K9 equals the woven K8 at all {len(kernels['K8']['cases'])} K8 cases, "
          "int16 and f32, one launch per call")

    # 3, the big tier's shapes: K1, K4 and K3 where the staged routes and the
    # reference tier above the cap give them planes 4-16x larger, against
    # their plain versions run in row bands (one plane row of halo above and
    # below, replicated only at the image's own edges: the whole image's
    # output in bounded memory), compared on the card
    def plain_banded(kid, args, rows=256):
        planes = args[0] if kid == "K4" else args
        h = planes[0].shape[-2]
        outs = None
        for r0 in range(0, h, rows):
            r1 = min(r0 + rows, h)
            a = max(r0 - 1, 0)
            cut = [p[..., a:min(r1 + 1, h), :].contiguous() for p in planes]
            res = call(kernels[kid], "plain", (cut, args[1]) if kid == "K4" else cut)
            if outs is None:
                outs = [torch.empty(p.shape, dtype=torch.uint8, device=dev) for p in planes[:len(res)]]
            for o, r in zip(outs, res):
                o[..., r0:r1, :] = r[..., r0 - a:r1 - a, :]
        return tuple(outs)

    for kid, case in BIG_KERNEL_CASES:
        k = kernels[kid]
        for dt in (torch.int16, torch.float32):
            args = k["args"](case, dt)
            got = call(k, "fn", args)
            d, same = dev_diff(got, plain_banded(kid, args))
            ms = cuda_ms(lambda: call(k, "fn", args), 10)
            bound_ms, bound_by = k["bound"](args)
            print(f"[3 kernels] {kid} {k['name']} {case} {dt} (big tier): max|diff| {d} LSB, "
                  f"identical {same:.6f}; kernel {ms:.4f} ms (10 wrapper calls, CUDA events), "
                  f"bound {bound_ms:.4f} ms ({bound_by}) on {card}")
            require(d == 0, f"{kid} differs from its plain version at {case}")
            k["max_abs_err"] = max(k["max_abs_err"], d)
            del args, got
            torch.cuda.empty_cache()

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
            imgs[(h, w)] = seeded_image(h, w)
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

    for (h, w, u, r2c), job in big_jobs.items():
        oracles[(h, w, u, r2c)], secs = job.result()
        print(f"[5 cli] fp64 oracle {w}x{h} x{u} {'r2c' if r2c else 'c2c'} for phase 8 in "
              f"{secs:.3f} s (worker process, beside phases 3-5)")

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
            if kid in ("K8", "K9"):
                extra = f", fp32 FMA form's bound {ycas_bound(*args, tensor_cores=False)[0]:.4f} ms"
            if "unfused" in k:
                extra += f", unfused form {cuda_ms(lambda: call(k, 'unfused', args), 50):.4f} ms"
            elif "vs" in k:
                extra = f", {k['vs'][0]} {cuda_ms(lambda: call(k, 'vs', args), 50):.4f} ms"
            print(f"[6 times] {kid} {k['name']} {case} {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms{extra}, bound {bound_ms:.4f} ms ({bound_by}) on {card}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("bound_by", bound_by)):
                k.setdefault(key, v)  # the int16 reading goes into the JSON line
    # the eager times above include each wrapper's host work, which for K4
    # takes about as long as its kernel: the device alone of the redesigned
    # kernels K1, K2, K3, K3h, K4, K5, K6, K7, K8, K9 and K10b, printed
    # only; for K8 and K9 also their unfused form's and its y GEMM's alone,
    # for K7 and K10b K3's and K10c's alone on the same image and each
    # one's bound and share of it
    for kid in ("K1", "K2", "K3", "K3h", "K4", "K5", "K6", "K7", "K8", "K9", "K10b"):
        k = kernels[kid]
        for case, dt in ((case, dt) for case in k["cases"][:k.get("timed", 1)]
                         for dt in k.get("dtypes", (torch.int16, torch.float32))):
            args = k["args"](case, dt)
            alone = graph_ms(lambda: call(k, "fn", args), 50)
            extra = ""
            if kid in ("K8", "K9"):
                extra = (f"; unfused form {graph_ms(lambda: call(k, 'unfused', args), 50):.4f} "
                         f"ms, its y GEMM {graph_ms(lambda: ycas_gemm(*args), 50):.4f} ms")
            elif "beside" in k:
                label, form = k["beside"]
                other = graph_ms(lambda: form(*args, 0.2), 50)
                b = k["bound"](args)[0]
                extra = (f", bound {b:.4f} ms, share {b / alone:.3f}; {label} alone on the "
                         f"same image {other:.4f} ms, share {b / other:.3f}")
            print(f"[6 times] {kid} {k['name']} {case} {dt}: device alone {alone:.4f} "
                  f"ms{extra} (50 calls replayed from one CUDA graph) on {card}")
    grid_u8 = [torch.randint(0, 256, (C, 720, 1280), generator=gen, device=dev,
                             dtype=torch.uint8) for _ in range(9)]
    ms = cuda_ms(lambda: weave_grid_u8(grid_u8, 3), 50)
    print(f"[6 times] weave_grid_u8 9 x {(C, 720, 1280)} uint8 (stack + reshape): "
          f"{ms:.4f} ms on {card}")

    # 7. batched: frames folded into the kernels' plane axis, the folder CLI
    batched_phase(dev, card, kernels, oracles, image, zero_counters)

    # 8. the big tier and fp64
    big_phase(dev, card, oracles, launches_of, zero_counters)

    # 9. the engine surface and -profile
    engine_phase(dev, card, engine_jobs, launches_of, zero_counters)

    # 10. the sp pencil mode and dp batches
    sp_phase(dev, card, kernels, oracles, image, launches_of, zero_counters)

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
