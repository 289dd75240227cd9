"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's routes (vkresample_tpu_torch: R2C upscale with CAS
sharpen, half storage -p 2 and fp32 -p 0) on the card at full frame sizes,
and fails (non-zero exit, no result line) unless every phase passes:

  1. device   a CUDA device is present; prints its name and power limit
  2. build    builds the CUDA kernels from vkresample_tpu_torch/csrc/
  3. kernels  each kernel against its plain PyTorch version on seeded
              inputs at its routes' shapes (<= 1 u8 LSB, >= 99.9 % of
              pixels identical)
  4. routes   each route through the entry point a user calls
              (build_upscale(plan, planes_out=True) as the CLI does, or
              upscale()) against the fp64 oracle (<= 1 LSB); every
              kernel's launch counter is set to 0 just before each route
              and read just after, and must be > 0 exactly for the
              route's kernels:
                quad     2048x1024 -> 4096x2048 u=2, -p 2 and -p 0    K1
                rows     1440x1080 -> 2880x2160 u=2, -p 2 and -p 0    K2
                woven    upscale() 2048x1024 -> 4096x2048, -p 2       K2
                u=3      1280x720 -> 3840x2160, -p 2 and -p 0         K3
                chain    1280x720 -> 1920x1080 at 1.5x, -p 0          K3
                xla      -engine xla 1920x1080 -> 3840x2160, -p 0     K3
  5. CLI      python -m vkresample_tpu_torch on the samples (-validate),
              the 256x128 sample at u=2 and u=1.5 against its golden PNGs
              (<= 1 LSB), and a frame whose width is not a multiple of 128
  6. times    ms/frame of every route (-n 20, CUDA events) and each
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
TOL_LSB = 1
MIN_IDENTICAL = 0.999
C = 3

# route name -> ((h, w), upscale, precision, engine, entry, kernels it runs)
ROUTES = {
    "quad -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", "planes", {"K1"}),
    "quad -p 0": ((1024, 2048), 2.0, "SINGLE", "AUTO", "planes", {"K1"}),
    "rows -p 2": ((1080, 1440), 2.0, "HALF", "AUTO", "planes", {"K2"}),
    "rows -p 0": ((1080, 1440), 2.0, "SINGLE", "AUTO", "planes", {"K2"}),
    "woven upscale() -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", "woven", {"K2"}),
    "u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", "woven", {"K3"}),
    "u=3 -p 0": ((720, 1280), 3.0, "SINGLE", "AUTO", "woven", {"K3"}),
    "chain 1.5x -p 0": ((720, 1280), 1.5, "SINGLE", "AUTO", "woven", {"K3"}),
    "xla -p 0": ((1080, 1920), 2.0, "SINGLE", "XLA", "woven", {"K3"}),
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

    from vkresample_tpu_torch.io.png import weave4_host

    if fmt == "quad":
        return np.moveaxis(weave4_host(*[p.cpu().numpy() for p in out]), 0, -1)
    if fmt == "rows":
        e, d = (p.cpu().numpy() for p in out)
        return np.moveaxis(np.stack([e, d], axis=2).reshape(C, plan.H, plan.W), 0, -1)
    return out.cpu().numpy()


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
    from vkresample_tpu_torch.io.png import read_png, write_png
    from vkresample_tpu_torch.ops import cas_cuda
    from vkresample_tpu_torch.ops.cas import to_i16_storage
    from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle
    from vkresample_tpu_torch.pipeline.timing import time_amortized
    from vkresample_tpu_torch.pipeline.upscale import planes_format

    kernels = {
        "K1": dict(
            name="cas_parity4_planes_u2", fn=cas_cuda.cas_parity4_planes_u2,
            plain=cas_cuda.cas_parity4_planes_u2_reference, n_in=4,
            source="vkresample_tpu_torch/csrc/cas_quad.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:1432",
            shapes=[(C, 1024, 2048), (2, 37, 200)],
        ),
        "K2": dict(
            name="cas_parity_planes_u2", fn=cas_cuda.cas_parity_planes_u2,
            plain=cas_cuda.cas_parity_planes_u2_reference, n_in=2,
            source="vkresample_tpu_torch/csrc/cas_parity.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:777",
            shapes=[(C, 1080, 2880), (2, 37, 200)],
        ),
        "K3": dict(
            name="cas_quantize", fn=cas_cuda.cas_quantize,
            plain=cas_cuda.cas_quantize_reference, n_in=1,
            source="vkresample_tpu_torch/csrc/cas_woven.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:543",
            shapes=[(C, 2160, 3840), (2, 37, 201)],
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

    # 3. each kernel against its plain version at its routes' shapes
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def pre_cas(shape, n):
        return [torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1 for _ in range(n)]

    for kid, k in kernels.items():
        k["max_abs_err"] = 0
        for shape in k["shapes"]:
            base = pre_cas(shape, k["n_in"])
            for ins in (base, [to_i16_storage(p) for p in base]):
                got = k["fn"](*ins, 0.2)
                torch.cuda.synchronize()
                want = k["plain"](*ins, 0.2)
                got, want = ((x,) if k["n_in"] == 1 else x for x in (got, want))
                d, same = u8_diff(got, want)
                print(f"[3 kernels] {kid} {k['name']} {shape} {ins[0].dtype}: "
                      f"max|diff| {d} LSB, identical {same:.6f}")
                require(d <= TOL_LSB and same >= MIN_IDENTICAL,
                        f"{kid} disagrees with its plain version at {shape}")
                k["max_abs_err"] = max(k["max_abs_err"], d)

    # 4. every route at full size, through the user's entry points
    oracles, imgs, fns = {}, {}, {}
    for k in kernels.values():
        k["launches"] = 0
    for route, ((h, w), u, prec, engine, entry, runs) in ROUTES.items():
        plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec],
                           engine=Engine[engine])
        if (h, w) not in imgs:
            imgs[(h, w)] = np.random.default_rng(SEED + h + w).integers(0, 256, (h, w, C), np.uint8)
        img = imgs[(h, w)]
        if (h, w, u) not in oracles:
            t0 = time.perf_counter()
            oracles[(h, w, u)] = upscale_oracle(img, plan)
            print(f"[4 routes] fp64 oracle {w}x{h} -> {plan.W}x{plan.H} in "
                  f"{time.perf_counter() - t0:.3f} s")
        fmt = planes_format(plan) if entry == "planes" else None
        require(entry == "woven" or fmt is not None, f"{route}: no parity planes")
        for k in kernels.values():
            k["fn"].launches = 0
        t0 = time.perf_counter()
        if entry == "planes":
            fns[route] = build_upscale(plan, dev, planes_out=True)
            out = fns[route](img)
        else:
            out = upscale(img, u, plan=plan, device=dev)
            fns[route] = build_upscale(plan, dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        counts = {kid: k["fn"].launches for kid, k in kernels.items()}
        got = woven_hwc(out, fmt, plan)
        require(got.shape == (plan.H, plan.W, C) and got.dtype == np.uint8,
                f"{route}: bad output {got.shape} {got.dtype}")
        d = int(np.abs(got.astype(np.int16) - oracles[(h, w, u)].astype(np.int16)).max())
        print(f"[4 routes] {route} ({fmt or 'woven'}): {w}x{h} -> {plan.W}x{plan.H} "
              f"first frame (banks built, uploaded) in {setup:.3f} s; max|diff| vs fp64 "
              f"oracle {d} LSB; launches {counts}")
        require(d <= TOL_LSB, f"{route} is {d} LSB from the oracle")
        for kid, n in counts.items():
            require((n > 0) == (kid in runs),
                    f"{route}: {kid} launched {n} times, expected {'some' if kid in runs else 'none'}")
            kernels[kid]["launches"] += n
    for kid, k in kernels.items():
        print(f"[4 routes] {kid} {k['name']} launches over the routes: {k['launches']}")

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
    for kid, k in kernels.items():
        base = pre_cas(k["shapes"][0], k["n_in"])
        for ins in ([to_i16_storage(p) for p in base], base):
            ms = cuda_ms(lambda: k["fn"](*ins, 0.2), 50)
            plain_ms = cuda_ms(lambda: k["plain"](*ins, 0.2), 10)
            print(f"[6 times] {kid} {k['name']} {k['shapes'][0]} {ins[0].dtype}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")
            k.setdefault("ms", ms)
            k.setdefault("plain_ms", plain_ms)

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda"} | {key: k[key] for key in (
            "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")}
        for k in kernels.values()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
