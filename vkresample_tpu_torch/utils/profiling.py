"""Profiling hooks (counterpart of vkresample_tpu/utils/profiling.py).

The reference's tracing story is chrono around the queue submit plus the
`-n` amortization flag (VkResample.cpp:1270-1278, SURVEY §5.1); the port
keeps those semantics in pipeline/timing.py and adds an optional device
profiler trace (`-profile DIR` on the CLI): torch.profiler over the host
and, where there is a card, its CUDA kernels, written as a Chrome trace
(``DIR/<host>_<pid>.<ns>.pt.trace.json``) that Perfetto, chrome://tracing
and TensorBoard's profiler plugin open.

Inside a call of a built pipeline the port opens the spans of SPANS with
span(): one tree per call under its "vkr.call".  They are torch.profiler
user annotations, on the profiler's clock beside the device activity, so in
a Chrome or Perfetto trace each span's row shows which kernels the stage
launched.  With no profiler running span() returns a shared null context:
the spans cost a flag read each and no profiler call.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
import torch.autograd.profiler as _autograd_profiler
import torch.profiler

# The span names, outermost first, and who reads each: the benchmark's
# port_* metrics (vkbench/spans.py), its idle-gap breakdown, which labels
# the device's idle time by the innermost span open on the host, and an
# operator's -profile trace.
SPANS = (
    "vkr.call",      # one call of a built pipeline, pipeline/upscale.py::_build:
                     # port_idle_pct.realtime, port_dispatch_ms_p95.realtime,
                     # port_dispatch_pct.batch
    "vkr.layout",    # the planar copy of the input, the output weave or movedim
    "vkr.precas",    # the pre-CAS transform, whichever route runs it
    "vkr.precas.x",  # r2c_quad and r2c_quad_staged: the x pass (P00, P01, the
                     # y-Nyquist correction rows)
    "vkr.precas.y",  # the same two: the y pass (P10, P11 and their correction)
    "vkr.codec",     # the Q2.14 store and load, ops/cas.py (-p 2)
    "vkr.cas",       # the CAS kernel's call, its wrapper included
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """torch.profiler.record_function(name) while a profiler runs, else a
    shared null context (no object built, nothing called in torch.ops)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def maybe_trace(trace_dir):
    """Context manager: torch.profiler over the block with its Chrome trace
    written into trace_dir when trace_dir is set, no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(trace_dir, name))
