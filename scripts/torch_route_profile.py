"""Where a frame's time goes on the card, per route of the PyTorch port.

    python3 scripts/torch_route_profile.py                 # the c2c routes
    python3 scripts/torch_route_profile.py all             # every route and run
    python3 scripts/torch_route_profile.py "quad -p 2" ...  # named routes or runs

The routes, the fused-y runs, the woven-CAS A/B runs ("cas ab K3", "cas ab
K6 bh=64" ..., "cas ab K7 bh=128") and the CAS-split runs ("cas split
K10a", "cas split K10b bh=64", "cas split K10b bh=128", "cas split K10c")
are chip_smoke.py's ROUTES, FUSED, CAS_AB and CAS_SPLIT (full frame sizes,
3 channels, a seeded random frame already on the device).  Every frame
runs its GEMMs inside pipeline/upscale.py::fp32_matmul (the built
pipelines and chip_smoke's frame functions pin it per call), so the
CUDA-graph capture records fp32 GEMMs too.  For each it prints, with the
card's name and power limit:

  ms/frame      -n 20 through the entry point, CUDA events (as chip_smoke)
  graph         the same frame captured once in a CUDA graph and replayed
                20 times: the frame's time without the host's dispatch
  busy, idle    torch.profiler over 10 frames: the sum of device kernel
                time per frame, and the share of an unprofiled frame
                (ms/frame above) in which no kernel runs, 1 - busy/ms;
                the profiled frame's own span is printed too (the
                profiler's host overhead stretches it)
  launches      device kernels per frame
  top kernels   the largest device-time sums per frame, by kernel name,
                and the port's CAS kernels where they are not among them

Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 10


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _graph_ms(fn, x, n: int = 20) -> float:
    """ms per replay of one frame captured in a CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(x)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def route_fn(name, dev):
    """(plan, frame function) of a chip_smoke route, fused-y or A/B run."""
    from chip_smoke import (CAS_AB, CAS_AB_FRAME, CAS_SPLIT, FUSED, ROUTES, cas_ab_fn,
                            cas_split_fn, fused_y_fn)

    from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale

    for runs, make in ((CAS_AB, cas_ab_fn), (CAS_SPLIT, cas_split_fn)):
        if name in runs:
            (h, w), (kid, bh) = CAS_AB_FRAME, runs[name]
            plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
            return plan, make(plan, dev, kid, bh)
    if name in FUSED:
        (h, w), prec, kid, _ = FUSED[name]
        plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision[prec])
        return plan, fused_y_fn(plan, dev, kid)
    (h, w), u, prec, engine, r2c, entry, _ = ROUTES[name]
    plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision[prec], r2c=r2c,
                       engine=Engine[engine])
    return plan, build_upscale(plan, dev, planes_out=entry == "planes")


def profile_route(name, dev, card) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vkresample_tpu_torch.pipeline.timing import time_amortized

    plan, fn = route_fn(name, dev)
    h, w = plan.h, plan.w
    img = np.random.default_rng(20261016 + h + w).integers(0, 256, (h, w, 3), np.uint8)
    x = torch.from_numpy(img).to(dev)
    _, ms = time_amortized(fn, (x,), 20, dev)
    try:
        graph = f"{_graph_ms(fn, x):.4f} ms/frame"
    except RuntimeError as e:  # a frame that cannot be captured says why
        graph = f"not capturable ({str(e).splitlines()[0][:120]})"
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(FRAMES):
            fn(x)
        end.record()
        end.synchronize()
    span = start.elapsed_time(end) / FRAMES
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / FRAMES
    launches = sum(e.count for e in kernels) / FRAMES
    print(f"[{name}] {w}x{h} -> {plan.W}x{plan.H}: {ms:.4f} ms/frame; graph {graph}; "
          f"busy {busy:.4f} ms/frame (idle {max(0.0, 1 - busy / ms):.3f}; profiled frame "
          f"{span:.4f} ms); {launches:.0f} kernel launches/frame; {card}")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:8] + [e for e in ranked[8:] if "cas_" in e.key]:
        print(f"[{name}]   {e.self_device_time_total / 1e3 / FRAMES:.4f} ms/frame "
              f"x{e.count / FRAMES:.0f}  {e.key[:110]}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs one GPU")
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import CAS_AB, CAS_SPLIT, FUSED, ROUTES

    names = ([n for n in ROUTES if "c2c" in n] if not argv
             else list(ROUTES) + list(FUSED) + list(CAS_AB) + list(CAS_SPLIT) if argv == ["all"]
             else argv)
    card = _card()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    for name in names:
        profile_route(name, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
