"""Dispatch-overhead-amortized timing with the reference's -n semantics:
one warm-up call, then n pipeline repeats, one sync at the end, elapsed / n
(VkResample.cpp:1249-1279)."""
from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def time_amortized(fn: Callable, args: tuple, num_iter: int,
                   device=None) -> Tuple[object, float]:
    """Run fn(*args) once to warm up, then num_iter times; return (last
    result, ms per call).  On a CUDA device the interval is taken with CUDA
    events on the current stream; on the CPU with the host clock."""
    n = max(1, int(num_iter))
    device = torch.device(device) if device is not None else None
    # warm-up (first launch, kernel build); its result is dropped so the
    # timed calls reuse its memory instead of growing the allocator
    fn(*args)
    if device is not None and device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                out = fn(*args)
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    return out, (time.perf_counter() - t0) * 1000.0 / n
