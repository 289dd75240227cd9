"""Profiling hooks (counterpart of vkresample_tpu/utils/profiling.py).

The reference's tracing story is chrono around the queue submit plus the
`-n` amortization flag (VkResample.cpp:1270-1278, SURVEY §5.1); the port
keeps those semantics in pipeline/timing.py and adds an optional device
profiler trace (`-profile DIR` on the CLI): torch.profiler over the host
and, where there is a card, its CUDA kernels, written as a Chrome trace
(``DIR/<host>_<pid>.<ns>.pt.trace.json``) that Perfetto, chrome://tracing
and TensorBoard's profiler plugin open.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time


@contextlib.contextmanager
def maybe_trace(trace_dir):
    """Context manager: torch.profiler over the block with its Chrome trace
    written into trace_dir when trace_dir is set, no-op otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(trace_dir, name))
