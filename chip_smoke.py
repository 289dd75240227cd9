"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (vkresample_tpu_torch: u=2 R2C upscale with CAS
sharpen, 2048x1024 -> 4096x2048, half storage -p 2 and fp32 -p 0) on the
card, and fails (non-zero exit, no result line) unless every phase passes:

  1. device   a CUDA device is present; prints its name and power limit
  2. build    builds the CUDA kernels from vkresample_tpu_torch/csrc/
  3. kernels  each kernel against its plain PyTorch version on seeded
              inputs at the main path's shapes (<= 1 u8 LSB, >= 99.9 %
              of pixels identical)
  4. slice    build_upscale(plan, planes_out=True), the CLI's call, at the
              flagship shape in -p 2 and -p 0 against the fp64 oracle
              (<= 1 LSB), with every kernel's launch counter read around it
  5. CLI      python -m vkresample_tpu_torch on the samples (-validate),
              and the 256x128 sample against its golden PNG (<= 1 LSB)
  6. times    ms/frame of both slice runs (-n 20, CUDA events) and each
              kernel against its plain version

It imports nothing of JAX.  The last stdout line is the result JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
FLAGSHIP = (1024, 2048)  # (h, w) of the source frame
TOL_LSB = 1
MIN_IDENTICAL = 0.999


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


def u8_diff(got, want):
    """(max |diff|, share identical) over matching uint8 tensors/arrays."""
    import numpy as np

    g = [np.asarray(x.cpu() if hasattr(x, "cpu") else x).astype(np.int16) for x in got]
    w = [np.asarray(x.cpu() if hasattr(x, "cpu") else x).astype(np.int16) for x in want]
    d = max(int(np.abs(a - b).max()) for a, b in zip(g, w))
    same = sum(int((a == b).sum()) for a, b in zip(g, w)) / sum(a.size for a in g)
    return d, same


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # 1. device
    require(torch.cuda.is_available(), "no CUDA device: the smoke run needs one GPU")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card}  torch {torch.__version__} cuda {torch.version.cuda}")

    from vkresample_tpu_torch import Precision, UpscalePlan, _build, build_upscale
    from vkresample_tpu_torch.io.png import read_png, weave4_host
    from vkresample_tpu_torch.ops.cas import to_i16_storage
    from vkresample_tpu_torch.ops.cas_cuda import (
        cas_parity4_planes_u2,
        cas_parity4_planes_u2_reference,
    )
    from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle
    from vkresample_tpu_torch.pipeline.timing import time_amortized

    kernels = {
        "cas_parity4_planes_u2": dict(
            fn=cas_parity4_planes_u2,
            plain=cas_parity4_planes_u2_reference,
            route="cuda",
            source="vkresample_tpu_torch/csrc/cas_quad.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:1432",
        ),
    }

    # 2. build
    t0 = time.perf_counter()
    _build.load_kernels()
    print(
        f"[2 build] {_build.last_build['path']}: "
        f"{'compiled' if _build.last_build['compiled'] else 'found built'} "
        f"in {time.perf_counter() - t0:.3f} s (nvcc {_build.last_build['seconds']:.3f} s)"
    )

    # 3. each kernel against its plain version at the main path's shapes
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0
    C = 3
    for shape in [(C,) + FLAGSHIP, (2, 37, 200)]:
        base = [torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1 for _ in range(4)]
        for planes in (base, [to_i16_storage(p) for p in base]):
            got = cas_parity4_planes_u2(*planes, 0.2)
            torch.cuda.synchronize()
            want = cas_parity4_planes_u2_reference(*planes, 0.2)
            d, same = u8_diff(got, want)
            print(f"[3 kernels] quad CAS {shape} {planes[0].dtype}: "
                  f"max|diff| {d} LSB, identical {same:.6f}")
            require(d <= TOL_LSB and same >= MIN_IDENTICAL,
                    f"quad CAS disagrees with its plain version at {shape}")
            max_err = max(max_err, d)
    kernels["cas_parity4_planes_u2"]["max_abs_err"] = max_err

    # 4. the slice end to end, through the entry point the CLI uses
    h, w = FLAGSHIP
    img = np.random.default_rng(SEED).integers(0, 256, (h, w, C), np.uint8)
    plans = {
        mode: UpscalePlan(h=h, w=w, upscale=2.0, precision=prec)
        for mode, prec in (("-p 2", Precision.HALF), ("-p 0", Precision.SINGLE))
    }
    t0 = time.perf_counter()
    want = upscale_oracle(img, plans["-p 0"])
    print(f"[4 slice] fp64 oracle {w}x{h} -> {2 * w}x{2 * h} in "
          f"{time.perf_counter() - t0:.3f} s")
    fns = {}
    for k in kernels.values():
        k["fn"].launches = 0
    for mode, plan in plans.items():
        t0 = time.perf_counter()
        fns[mode] = build_upscale(plan, dev, planes_out=True)
        out = fns[mode](img)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        require(len(out) == 4 and all(
            p.shape == (C, h, w) and p.dtype == torch.uint8 and p.is_cuda
            for p in out), f"slice {mode}: bad planes")
        got = np.moveaxis(weave4_host(*[p.cpu().numpy() for p in out]), 0, -1)
        d = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        print(f"[4 slice] {mode}: first frame (banks built, uploaded) in "
              f"{setup:.3f} s; max|diff| vs fp64 oracle {d} LSB")
        require(d <= TOL_LSB, f"slice {mode} is {d} LSB from the oracle")
    for name, k in kernels.items():
        k["launches"] = k["fn"].launches
        print(f"[4 slice] {name} launches on the main path: {k['launches']}")
        require(k["launches"] > 0, f"{name} never launched on the main path")

    # 5. the CLI on the samples
    out_dir = os.path.join(ROOT, "vkresample_tpu_torch", "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    samples = os.path.join(ROOT, "samples")
    for name, extra in (("test_1920x1080.png", ["-p", "2"]), ("test_256x128.png", [])):
        out_png = os.path.join(out_dir, "cli_" + name)
        cmd = [sys.executable, "-m", "vkresample_tpu_torch", "-i",
               os.path.join(samples, name), "-o", out_png, "-u", "2",
               *extra, "-validate"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"[5 cli] {line}")
        require(proc.returncode == 0,
                f"CLI on {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
    got = read_png(os.path.join(out_dir, "cli_test_256x128.png"))
    gold = read_png(os.path.join(samples, "golden_256x128_x2.png"))
    d = int(np.abs(got.astype(np.int16) - gold.astype(np.int16)).max())
    print(f"[5 cli] 256x128 x2 vs golden: max|diff| {d} LSB")
    require(got.shape == gold.shape and d <= TOL_LSB, "CLI output differs from the golden PNG")

    # 6. times, on this card
    x = torch.from_numpy(img).to(dev)
    for mode, fn in fns.items():
        _, ms = time_amortized(fn, (x,), 20, dev)
        print(f"[6 times] slice {mode} {w}x{h} -> {2 * w}x{2 * h}: "
              f"{ms:.4f} ms/frame (-n 20, CUDA events) on {card}")
    base = [torch.rand((C,) + FLAGSHIP, generator=gen, device=dev) * 1.3 - 0.1 for _ in range(4)]
    for name, k in kernels.items():
        for planes in ([to_i16_storage(p) for p in base], base):
            ms = cuda_ms(lambda: k["fn"](*planes, 0.2), 50)
            plain_ms = cuda_ms(lambda: k["plain"](*planes, 0.2), 10)
            print(f"[6 times] {name} {(C,) + FLAGSHIP} {planes[0].dtype}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")
            k.setdefault("ms", ms)
            k.setdefault("plain_ms", plain_ms)

    print(json.dumps({"kernels": [
        {"name": name} | {key: k[key] for key in (
            "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms")}
        for name, k in kernels.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
