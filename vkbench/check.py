"""The comparison that decides `correct`: the port's uint8 output of the
frames that the timed path produced, against the plain reference.

Two numbers per run, each with the limit that its configuration file
states (check): max_lsb, the widest gap of any output value from the
reference's, in uint8 steps; mismatch_pct, the share of output values that
differ from the reference's at all.
"""
from __future__ import annotations

import math

import torch


def weave(planes, fmt) -> torch.Tensor:
    """The port's output -> the (N, C, H, W) uint8 image.  'quad' and
    'grid': p*p planes (N, C, H/p, W/p) in row-major (ry, rx) order, plane
    ry*p + rx holding out[..., ry::p, rx::p]; 'rows': (E, D), the even and
    odd output rows; None: the image itself, bare or as the one element of
    a tuple or list (as loadgen and harness.Keeper hand every output on)."""
    if fmt is None:
        if isinstance(planes, torch.Tensor):
            return planes
        if len(planes) != 1:
            raise ValueError(f"a woven output is one image, not {len(planes)} planes")
        return planes[0]
    if fmt == "rows":
        p_y, p_x = 2, 1
    elif fmt in ("quad", "grid"):
        p_y = p_x = math.isqrt(len(planes))
    else:
        raise ValueError(f"unknown plane layout {fmt!r}")
    n, c, h, w = planes[0].shape
    out = torch.empty((n, c, h * p_y, w * p_x), dtype=planes[0].dtype, device=planes[0].device)
    for i, p in enumerate(planes):
        out[..., i // p_x::p_y, i % p_x::p_x] = p
    return out


def compare(out: torch.Tensor, ref: torch.Tensor):
    """(widest gap in uint8 steps, values that differ, values) of two
    uint8 tensors of one shape."""
    if out.shape != ref.shape:
        raise ValueError(f"output {tuple(out.shape)} against reference {tuple(ref.shape)}")
    diff = (out.to(torch.int16) - ref.to(torch.int16)).abs_()
    return int(diff.max()), int(torch.count_nonzero(diff)), diff.numel()


class Tally:
    """The numbers compared, summed over the frames checked."""

    def __init__(self):
        self.max_lsb, self.mismatched, self.values, self.frames = 0, 0, 0, 0

    def add(self, out: torch.Tensor, ref: torch.Tensor) -> int:
        """Count one batch of frames in; returns its widest gap."""
        gap, bad, n = compare(out, ref)
        self.max_lsb = max(self.max_lsb, gap)
        self.mismatched += bad
        self.values += n
        self.frames += out.shape[0]
        return gap

    def numbers(self) -> dict:
        return {"max_lsb": self.max_lsb,
                "mismatch_pct": 100.0 * self.mismatched / self.values if self.values else None}


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number is there and within its limit."""
    return all(numbers.get(k) is not None and numbers[k] <= v for k, v in limits.items())
