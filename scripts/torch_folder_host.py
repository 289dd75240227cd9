"""Time the host side of the folder path that the folder CLI leaves alone:
the zlib reader's Paeth rows in C against its Python row loops, and the
device -> host copy of a batch's planes into pinned buffers against the
pageable copy the CLI makes.

    python3 scripts/torch_folder_host.py

The frame is chip_smoke.py's folder frame: seeded 2048x1024 RGB noise
(numpy seed 20261016 + 12), written as a PNG with every row Paeth filtered
(chip_smoke.py::paeth_png); the batch is 8 such frames as the quad -p 2
route's 4 x (24, 1024, 2048) uint8 planes on the card.  It prints, with
the card's name and power limit:

  paeth   ms to read the frame with io/png.py's zlib reader, the C row
          filters (io/native/unfilter.cpp) and the Python loops in turns
          (C, Python, C, Python), host clock; both decode the frame exactly
  d2h     ms to copy the batch's planes to the host, pageable (.cpu(), as
          cli.py::run_batched does) and into pinned buffers in turns, five
          of each, host clock after a synchronize

Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the folder host timings need one GPU")
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import SEED, gpu_line, paeth_png

    from vkresample_tpu_torch.io import png

    card = gpu_line()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}")
    h, w = 1024, 2048
    frame = np.random.default_rng(SEED + 12).integers(0, 256, (h, w, 3), np.uint8)
    root = os.path.join(ROOT, "vkresample_tpu_torch", "build", "folder_host")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "paeth.png")
    paeth_png(path, frame)
    c_filters = png._filters()
    if c_filters is None:
        print("the C row filters did not build (no g++)")
        return 1
    readings = {"C": [], "Python": []}
    saved = png._filters
    try:
        for label in ("C", "Python", "C", "Python"):
            png._filters = (lambda: c_filters) if label == "C" else (lambda: None)
            t0 = time.perf_counter()
            img = png._zlib_read(path)
            readings[label].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(img, frame):
                print(f"the Paeth frame decodes wrong with the {label} row filters")
                return 1
    finally:
        png._filters = saved
        shutil.rmtree(root, ignore_errors=True)
    for label, ms in readings.items():
        print(f"[paeth] zlib reader, one Paeth-filtered {w}x{h} RGB frame, row filters in "
              f"{label}: {', '.join(f'{m:.3f}' for m in ms)} ms (host clock) on {card}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    planes = [torch.randint(0, 256, (24, h, w), generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(4)]
    pinned = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in planes]
    pageable, into_pinned = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [p.cpu().numpy() for p in planes]
        pageable.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for dst, p in zip(pinned, planes):
            dst.copy_(p)
        into_pinned.append((time.perf_counter() - t0) * 1e3)
    n_bytes = sum(p.numel() for p in planes)
    print(f"[d2h] 4 quad planes of a batch of 8 ({n_bytes} bytes): pageable "
          f"{', '.join(f'{m:.4f}' for m in pageable)} ms; into pinned buffers "
          f"{', '.join(f'{m:.4f}' for m in into_pinned)} ms (host clock) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
