"""Batched upscale: N frames through one call of the single-frame pipeline
(counterpart of vkresample_tpu/pipeline/batched.py).

The pipeline broadcasts over leading frame dims (pipeline/upscale.py
_pipeline), and every CAS kernel folds frames x channels into its plane
count, so a batch runs each kernel of its route once: N*C planes in one
launch.  Eager PyTorch compiles no batch shape, so a short tail batch runs
at its own size with no zero padding.

A sequence of devices in place of one device is the JAX package's "dp"
mesh (parallel/mesh.py): the frames split evenly over the devices
(split_frames; ValueError unless their count divides the batch), each
device runs its own cached pipeline with its own banks and its own card's
dense cap (core/tuning.py) on its share, all launched from one host thread
(the launches on different cards overlap), with no collectives, and the
result is one output per device in frame order.  Repeats are allowed: ["cpu", "cpu"] or [cuda:0, cuda:0] split a
batch in two on one device.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import resolve_device
from ..core.plan import UpscalePlan
from ..core.tuning import plan_for
from ..parallel.mesh import data_parallel_devices, split_frames
from .upscale import _build


def build_batched_upscale(plan: UpscalePlan, device=None, planar_out: bool = False,
                          planes_out: bool = False) -> Callable:
    """(N, h, w, C) uint8 -> (N, H, W, C) uint8 ((N, C, H, W) when
    planar_out; with planes_out the parity planes of
    planes_format(plan), each with a leading N: 4 x (N, C, H/2, W/2) quad,
    2 x (N, C, H/2, W) rows, p^2 x (N, C, H/p, W/p) grid), on `device`
    (default: the current CUDA device; "cpu" runs the kernels' plain
    versions).  The function is build_upscale's, cached per (plan, device,
    flags) with its banks uploaded once.  ValueError past MAX_PLANES frames
    x channels (21845 three-channel frames).

    device may also be a list or tuple of devices (the "dp" mode, see the
    module docstring): the function then returns a list with each device's
    output for its N/k frames, in frame order.  Each device's share takes
    its card's dense cap (core/tuning.py), so with planes_out two cards
    with different rows may give different plane layouts."""
    if not isinstance(device, (list, tuple)):
        device = resolve_device(device)
        return _build(plan_for(plan, device), device, bool(planes_out), bool(planar_out))
    devices = data_parallel_devices(device)
    fns = [_build(plan_for(plan, d), d, bool(planes_out), bool(planar_out)) for d in devices]

    def run(imgs):
        imgs = torch.as_tensor(imgs)
        parts = split_frames(imgs.shape[0] if imgs.dim() else 0, devices)
        return [fn(imgs[s].to(d)) for fn, d, s in zip(fns, devices, parts)]

    return run


def upscale_batch(imgs, plan: UpscalePlan, device=None):
    """Convenience wrapper: (N, h, w, C) uint8 frames (numpy array or
    tensor) -> the (N, H, W, C) uint8 batch on the device, or with a list
    of devices each device's (N/k, H, W, C) share in frame order; TypeError
    on anything but 4-D uint8."""
    imgs = torch.as_tensor(imgs)
    if imgs.dtype != torch.uint8 or imgs.dim() != 4:
        raise TypeError(f"expected (N, h, w, C) uint8, got {tuple(imgs.shape)} {imgs.dtype}")
    return build_batched_upscale(plan, device)(imgs)
