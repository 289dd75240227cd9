"""Split the woven CAS kernels' time on the card into data movement and
arithmetic: the PyTorch port's counterpart of scripts/cas_split.py.

    python3 scripts/torch_cas_split.py

The frame is the JAX script's: a 2048x1024 -> 4096x2048 u=2 -p 2 plan, a
random uint8 frame (numpy seed 0), dense.r2c_rows without a storage codec
(GEMMs in full fp32) and the float32 dense.weave_rows image (3, 2048,
4096); then one kernel.  Each CAS kernel is paired with its copy-quantize
probe, which moves the same data and only quantizes:

  K3 (csrc/cas_rows.cu at u=1)       with K10a (the tile staging of K3's
                                     first design, which K3 no longer
                                     runs: the gap is now not K3's
                                     arithmetic alone)
  K7 (csrc/cas_mono.cu) at bh 64, 128 with K10b (K7's band pipeline), same bh

For each pair, in one process and in the script's alternating order (copy,
CAS, copy again, CAS again), it prints with the card's name and power
limit:

  frame     ms/frame of the whole frame, -n 20 after a warm-up, CUDA events
            (pipeline/timing.py::time_amortized)
  kernel    the kernel alone on the frame's woven image, CUDA events over
            50 launches after a warm-up
  split     the probe's time (data movement), what the CAS kernel spends
            beyond it (arithmetic) and that share of the CAS kernel's time,
            from the means of the two readings

Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# pair -> (the copy-quantize probe, the CAS kernel), each (kernel id, rows per band)
PAIRS = {
    "K3 tile": (("K10a", None), ("K3", None)),
    "K7 band bh=64": (("K10b", 64), ("K7", 64)),
    "K7 band bh=128": (("K10b", 128), ("K7", 128)),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the CAS split needs one GPU")
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import CAS_AB_FRAME, cas_ab_fn, cas_split_fn, cuda_ms, gpu_line, woven_fn

    from vkresample_tpu_torch import Precision, UpscalePlan
    from vkresample_tpu_torch.ops import cas_cuda, quantize_cuda
    from vkresample_tpu_torch.pipeline.timing import time_amortized

    card = gpu_line()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    h, w = CAS_AB_FRAME
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)).to(dev)
    v = woven_fn(plan, dev)(x)
    kernel = {
        "K10a": lambda bh: quantize_cuda.copy_quantize_tile(v),
        "K3": lambda bh: cas_cuda.cas_quantize(v, plan.sharpen),
        "K10b": lambda bh: quantize_cuda.copy_quantize_mono(v, bh),
        "K7": lambda bh: cas_cuda.cas_quantize_mono(v, plan.sharpen, bh),
    }
    make_frame = {"K10a": cas_split_fn, "K10b": cas_split_fn, "K3": cas_ab_fn, "K7": cas_ab_fn}
    print(f"woven image {tuple(v.shape)} {v.dtype}; bound of every kernel "
          f"{v.numel() * 5 / 3.35e12 * 1e3:.4f} ms ({v.numel() * 5 / 1e6:.1f} MB over 3.35 TB/s)")
    for label, pair in PAIRS.items():
        frames = {kid: make_frame[kid](plan, dev, kid, bh) for kid, bh in pair}
        frame_ms = {kid: [] for kid, _ in pair}
        kernel_ms = {kid: [] for kid, _ in pair}
        for kid, _ in pair + pair:  # copy, CAS, copy again, CAS again
            frame_ms[kid].append(time_amortized(frames[kid], (x,), 20, dev)[1])
        for kid, bh in pair + pair:
            kernel_ms[kid].append(cuda_ms(lambda: kernel[kid](bh), 50))
        for kid, bh in pair:
            name = kid + ("" if bh is None else f" bh={bh}")
            print(f"[{label}] {name}: frame {frame_ms[kid][0]:.4f}, {frame_ms[kid][1]:.4f} "
                  f"ms/frame; kernel {kernel_ms[kid][0]:.4f}, {kernel_ms[kid][1]:.4f} ms on {card}")
        (copy, _), (cas, _) = pair
        mean = {kid: sum(t) / len(t) for kid, t in kernel_ms.items()}
        arith = mean[cas] - mean[copy]
        print(f"[{label}] split: data movement ({copy}) {mean[copy]:.4f} ms, arithmetic "
              f"({cas} - {copy}) {arith:.4f} ms = {arith / mean[cas]:.3f} of {cas}'s "
              f"{mean[cas]:.4f} ms on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
