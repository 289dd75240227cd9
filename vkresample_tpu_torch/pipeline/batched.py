"""Batched upscale: N frames through one call of the single-frame pipeline
(counterpart of vkresample_tpu/pipeline/batched.py).

The pipeline broadcasts over leading frame dims (pipeline/upscale.py
_pipeline), and every CAS kernel folds frames x channels into its plane
count, so a batch runs each kernel of its route once: N*C planes in one
launch.  Eager PyTorch compiles no batch shape, so a short tail batch runs
at its own size with no zero padding.  The JAX package's mesh argument
(frames sharded over a data-parallel device mesh) is not ported: a batch
runs on one device (ROADMAP.md modules item 7).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import resolve_device
from ..core.plan import UpscalePlan
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
    x channels (21845 three-channel frames)."""
    return _build(plan, resolve_device(device), bool(planes_out), bool(planar_out))


def upscale_batch(imgs, plan: UpscalePlan, device=None) -> torch.Tensor:
    """Convenience wrapper: (N, h, w, C) uint8 frames (numpy array or
    tensor) -> the (N, H, W, C) uint8 batch on the device; TypeError on
    anything but 4-D uint8."""
    imgs = torch.as_tensor(imgs)
    if imgs.dtype != torch.uint8 or imgs.dim() != 4:
        raise TypeError(f"expected (N, h, w, C) uint8, got {tuple(imgs.shape)} {imgs.dtype}")
    return build_batched_upscale(plan, device)(imgs)
