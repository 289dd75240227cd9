"""Closed-loop load: the next call goes once fewer than `in_flight` calls
are outstanding, so a slower system is offered less load.

Traffic parameters (traffic/<name>.json):
  frames_per_call  frames in one call of the system (its batch)
  pool_calls       distinct seeded inputs, taken in turn
  input            "device": the inputs lie on the device before the
                   window; "pinned_host": they lie in pinned host memory
                   and each call uploads its own inside its timed span
  in_flight        calls outstanding at most (1: one frame at a time)
  warmup_calls     calls made in set-up, before the window
  check_calls      calls of the window whose output the check compares,
                   drawn from the seed

Every call's span is taken with CUDA events on the stream, recorded
before its upload and after its last launch, so a span is the device's
view from the call's submission to its completion, read to a microsecond
(a host clock reads a single frame no better than half a millisecond).
The window itself is taken with the host clock: from a synchronized start
to the synchronization after the last call, over every call dispatched.
"""
from __future__ import annotations

import contextlib
import time

import torch


class _Marks:
    """Stream marks: CUDA events on a card, the host clock elsewhere (the
    CPU tests, where every call has finished when it returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _call(fn, x, device, upload: bool):
    if upload:
        x = x.to(device, non_blocking=True)
    out = fn(x)
    return out if isinstance(out, (tuple, list)) else (out,)


def warm_up(fn, pool, traffic, device):
    """Run the traffic's warm-up calls, every shape of the window among
    them; returns (seconds per call, the last call's output planes)."""
    marks, upload = _Marks(device), traffic["input"] == "pinned_host"
    n = max(2, int(traffic["warmup_calls"]))
    for i in range(n - 1):
        out = _call(fn, pool[i % len(pool)], device, upload)
    marks.sync()
    a = marks.mark()
    out = _call(fn, pool[(n - 1) % len(pool)], device, upload)
    b = marks.mark()
    marks.sync()
    return marks.ms(a, b) / 1e3, out


def run_window(fn, pool, traffic, seconds: float, device, sample, keep,
               label=lambda name: contextlib.nullcontext()):
    """Drive `fn` for `seconds`; calls whose index is in `sample` hand
    their output to keep(index, planes) right after dispatch.  label(name)
    wraps the window ("vkbench.window") and each call ("vkbench.call") for
    a trace.  Returns a dict: calls, frames, t0 and t1 (host clock),
    window_s, latencies_ms (one per call)."""
    marks, upload = _Marks(device), traffic["input"] == "pinned_host"
    depth = max(1, int(traffic["in_flight"]))
    spans = []
    marks.sync()
    with label("vkbench.window"):
        t0 = time.perf_counter()
        stop = t0 + seconds
        i = 0
        while time.perf_counter() < stop:
            if i >= depth:
                marks.wait(spans[i - depth][1])
            with label("vkbench.call"):
                a = marks.mark()
                out = _call(fn, pool[i % len(pool)], device, upload)
                b = marks.mark()
            if i in sample:
                keep(i, out)
            del out
            spans.append((a, b))
            i += 1
        marks.sync()
        t1 = time.perf_counter()
    return {"calls": i, "frames": i * int(traffic["frames_per_call"]), "t0": t0, "t1": t1,
            "window_s": t1 - t0, "latencies_ms": [marks.ms(a, b) for a, b in spans]}
