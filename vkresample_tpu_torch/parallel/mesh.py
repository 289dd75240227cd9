"""Data-parallel device lists and frame sharding (counterpart of
vkresample_tpu/parallel/mesh.py).

The reference's only parallelism is frame-level: N host threads, each with
its own GPU, round-robin over files.  The JAX package shards a frame batch
over a 1-D "dp" device mesh with zero collectives on the hot path; here
the "dp" mesh is a list of torch devices, and a batch splits evenly over
it (pipeline/batched.py): each device runs its own copy of the pipeline on
its share of the frames, with its own banks.  The "sp" pencil mode (one
frame over several cards) is parallel/distributed.py.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core.config import resolve_device


def data_parallel_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a "dp" batch: every CUDA device (RuntimeError when
    there is none), or the given ones.  Repeats are allowed: ["cpu", "cpu"]
    or [cuda:0, cuda:0] split a batch in two on one device."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: the port never falls back to the CPU
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a data-parallel device list needs at least one device")
    return devs


def split_frames(n: int, devices: Sequence) -> List[slice]:
    """The frames of each device when n frames shard evenly over `devices`
    (the JAX package's even sharding of the leading axis): device i gets
    frames [i*n/k, (i+1)*n/k).  ValueError unless k divides n."""
    k = len(devices)
    if k < 1 or n % k:
        raise ValueError(f"{n} frames do not split evenly over {k} devices")
    m = n // k
    return [slice(i * m, (i + 1) * m) for i in range(k)]


def batch_for_devices(requested: int, n_files: int, n_dev: int) -> int:
    """The folder CLI's frames per batch (vkresample_tpu/cli.py:324-332):
    the requested -batch, else max(n_dev, min(8, n_files)); over several
    devices it is rounded down to a device multiple, and to at least one
    frame per device."""
    batch = requested or max(n_dev, min(8, n_files))
    if n_dev > 1:
        batch = max(n_dev, (batch // n_dev) * n_dev)
    return batch


def device_list_string() -> str:
    """The -devices printer (the reference prints 'Device id: N name: X',
    VkResample.cpp:239-268)."""
    if not torch.cuda.is_available():
        return "No CUDA devices found."
    return "\n".join(
        f"Device id: {i} name: {torch.cuda.get_device_name(i)}"
        for i in range(torch.cuda.device_count())
    )
