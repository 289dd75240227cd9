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
              u = 3 (full size) and u = 3, 4, 5, 7 (odd shape)
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
                c2c grid u=2  2048x1024 -> 4096x2048, -p 2           K1
                c2c grid u=3  1280x720 -> 3840x2160, -p 2 and -p 0   K4
                c2c grid 1.5x 1280x720 -> 1920x1080, -p 2            K4
                c2c woven upscale() u=3 1280x720, -p 2               K4
                c2c chain 2.5x 1280x720 -> 3200x1800, -p 0           K3
                xla c2c  -engine xla 1920x1080 -> 3840x2160, -p 0    K3
  5. CLI      python -m vkresample_tpu_torch on the samples (-validate),
              the 256x128 sample at u=2 and u=1.5 against its golden PNGs
              (<= 1 LSB), a frame whose width is not a multiple of 128,
              and -c2c at u=2 (1920x1080 sample) and u=3 (600x400 frame)
  6. times    ms/frame of every route (-n 20, CUDA events), each kernel
              against its plain version, and the device grid weave

The line before the card's line lists each kernel with its launches over
the routes, its worst difference, its time, its plain version's time and
its bound: the larger of the bytes it must move (inputs read once, outputs
written once) over 3.35 TB/s and ~40 fp32 operations per output pixel over
67 TFLOP/s (H100 SXM).  No single PyTorch call computes CAS, so
library_ms is null.  It imports nothing of JAX.  The last stdout line is
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
C = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
CAS_OPS_PER_PIXEL = 40  # cas_common.cuh: clip, min/max tree, blend, quantize

# route name -> ((h, w), upscale, precision, engine, r2c, entry, kernels it runs)
ROUTES = {
    "quad -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", True, "planes", {"K1"}),
    "quad -p 0": ((1024, 2048), 2.0, "SINGLE", "AUTO", True, "planes", {"K1"}),
    "rows -p 2": ((1080, 1440), 2.0, "HALF", "AUTO", True, "planes", {"K2"}),
    "rows -p 0": ((1080, 1440), 2.0, "SINGLE", "AUTO", True, "planes", {"K2"}),
    "woven upscale() -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", True, "woven", {"K2"}),
    "u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", True, "woven", {"K3"}),
    "u=3 -p 0": ((720, 1280), 3.0, "SINGLE", "AUTO", True, "woven", {"K3"}),
    "chain 1.5x -p 0": ((720, 1280), 1.5, "SINGLE", "AUTO", True, "woven", {"K3"}),
    "xla -p 0": ((1080, 1920), 2.0, "SINGLE", "XLA", True, "woven", {"K3"}),
    "c2c grid u=2 -p 2": ((1024, 2048), 2.0, "HALF", "AUTO", False, "planes", {"K1"}),
    "c2c grid u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", False, "planes", {"K4"}),
    "c2c grid u=3 -p 0": ((720, 1280), 3.0, "SINGLE", "AUTO", False, "planes", {"K4"}),
    "c2c grid 1.5x -p 2": ((720, 1280), 1.5, "HALF", "AUTO", False, "planes", {"K4"}),
    "c2c woven upscale() u=3 -p 2": ((720, 1280), 3.0, "HALF", "AUTO", False, "woven", {"K4"}),
    "c2c chain 2.5x -p 0": ((720, 1280), 2.5, "SINGLE", "AUTO", False, "woven", {"K3"}),
    "xla c2c -p 0": ((1080, 1920), 2.0, "SINGLE", "XLA", False, "woven", {"K3"}),
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

    from vkresample_tpu_torch.io.png import weave4_host, weave_grid_host

    if fmt == "quad":
        return np.moveaxis(weave4_host(*[p.cpu().numpy() for p in out]), 0, -1)
    if fmt == "grid":
        planes = [p.cpu().numpy() for p in out]
        return np.moveaxis(weave_grid_host(planes, int(round(len(planes) ** 0.5))), 0, -1)
    if fmt == "rows":
        e, d = (p.cpu().numpy() for p in out)
        return np.moveaxis(np.stack([e, d], axis=2).reshape(C, plan.H, plan.W), 0, -1)
    return out.cpu().numpy()


def cas_bound(shape, n_planes: int, in_bytes: int):
    """(bound_ms, bound_by) of a CAS kernel on n_planes input planes of
    `shape` giving as many uint8 planes."""
    px = n_planes
    for d in shape:
        px *= d
    t_bytes = px * (in_bytes + 1) / HBM_BYTES_PER_S
    t_ops = px * CAS_OPS_PER_PIXEL / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    from vkresample_tpu_torch.ops.weave import weave_grid_u8
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
        "K4": dict(
            name="cas_parity_grid_planes", fn=cas_cuda.cas_parity_grid_planes,
            plain=cas_cuda.cas_parity_grid_planes_reference,
            source="vkresample_tpu_torch/csrc/cas_grid.cu",
            replaces="vkresample_tpu/ops/cas_pallas.py:2152",
            shapes=[(C, 720, 1280), (2, 37, 200)], us=[3, 3, 4, 5, 7],
        ),
    }
    for k in kernels.values():
        # (shape, u) cases: the plane kernels' u is fixed, K4's varies
        k["cases"] = ([(k["shapes"][0], k["us"][0])] + [(k["shapes"][1], u) for u in k["us"][1:]]
                      if "us" in k else [(shape, None) for shape in k["shapes"]])

    def call(k, which, ins, u):
        """Kernel (which="fn") or plain version ("plain") on the planes;
        always a tuple of uint8 planes."""
        out = k[which](ins, u, 0.2) if u is not None else k[which](*ins, 0.2)
        return out if isinstance(out, tuple) else (out,)

    def n_in(k, u):
        return u * u if u is not None else k["n_in"]

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
        for shape, u in k["cases"]:
            base = pre_cas(shape, n_in(k, u))
            for ins in (base, [to_i16_storage(p) for p in base]):
                got = call(k, "fn", ins, u)
                torch.cuda.synchronize()
                want = call(k, "plain", ins, u)
                d, same = u8_diff(got, want)
                print(f"[3 kernels] {kid} {k['name']} {shape}{'' if u is None else f' u={u}'} "
                      f"{ins[0].dtype}: max|diff| {d} LSB, identical {same:.6f}")
                require(d <= TOL_LSB and same >= MIN_IDENTICAL,
                        f"{kid} disagrees with its plain version at {shape}")
                k["max_abs_err"] = max(k["max_abs_err"], d)

    # 4. every route at full size, through the user's entry points
    oracles, imgs, fns = {}, {}, {}
    for k in kernels.values():
        k["launches"] = 0
    for route, ((h, w), u, prec, engine, r2c, entry, runs) in ROUTES.items():
        plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec], r2c=r2c,
                           engine=Engine[engine])
        if (h, w) not in imgs:
            imgs[(h, w)] = np.random.default_rng(SEED + h + w).integers(0, 256, (h, w, C), np.uint8)
        img = imgs[(h, w)]
        key = (h, w, u, r2c)
        if key not in oracles:
            t0 = time.perf_counter()
            oracles[key] = upscale_oracle(img, plan)
            print(f"[4 routes] fp64 oracle {w}x{h} -> {plan.W}x{plan.H} "
                  f"{'r2c' if r2c else 'c2c'} in {time.perf_counter() - t0:.3f} s")
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
        d = int(np.abs(got.astype(np.int16) - oracles[key].astype(np.int16)).max())
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
    for kid, k in kernels.items():
        shape, u = k["cases"][0]
        base = pre_cas(shape, n_in(k, u))
        for ins in ([to_i16_storage(p) for p in base], base):
            ms = cuda_ms(lambda: call(k, "fn", ins, u), 50)
            plain_ms = cuda_ms(lambda: call(k, "plain", ins, u), 10)
            bound_ms, bound_by = cas_bound(shape, n_in(k, u), ins[0].element_size())
            print(f"[6 times] {kid} {k['name']} {n_in(k, u)} x {shape} {ins[0].dtype}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}) on {card}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("bound_by", bound_by)):
                k.setdefault(key, v)  # the int16 reading goes into the JSON line
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
