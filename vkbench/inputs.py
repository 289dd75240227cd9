"""Seeded input frames, made on the device in a few large calls.

Each pool entry of a run is a batch of frames drawn from its own
generator, seeded from (seed, entry), so the check can make the frames of
any entry again without keeping them.  The frames are band-limited like
natural images (CAS sharpens edges, and white noise has nothing else):
per frame and channel two sinusoid gradients of seeded frequency and phase
plus Gaussian noise (sigma 0.08) through a 5 x 5 box filter, as
tests/conftest.py::make_test_image draws them with numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BOX = 5
NOISE_SIGMA = 0.08


def entry_seed(seed: int, entry: int) -> int:
    """A 63-bit generator seed for pool entry `entry` of the run `seed`
    (any whole number >= 0)."""
    return int(np.random.SeedSequence([int(seed), int(entry)]).generate_state(1, np.uint64)[0] >> 1)


def make_frames(seed: int, entry: int, n: int, h: int, w: int, c: int, device) -> torch.Tensor:
    """(n, h, w, c) uint8 frames of pool entry `entry`, on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(entry_seed(seed, entry))
    freq = torch.randint(1, 9, (2, n, c, 1, 1), generator=gen, device=device).to(torch.float32)
    phase = torch.rand((2, n, c, 1, 1), generator=gen, device=device) * (2 * math.pi)
    x = torch.arange(w, device=device, dtype=torch.float32) / w
    y = (torch.arange(h, device=device, dtype=torch.float32) / h)[:, None]
    img = torch.randn((n, c, h + BOX, w + BOX), generator=gen, device=device) * NOISE_SIGMA
    img = img.cumsum(-2)
    img = (img[..., BOX:, :] - img[..., :-BOX, :]).cumsum(-1)
    img = (img[..., BOX:] - img[..., :-BOX]) / (BOX * BOX)
    img += 0.5
    img += 0.25 * torch.sin(2 * math.pi * freq[0] * x + phase[0])
    img += 0.2 * torch.cos(2 * math.pi * freq[1] * y + phase[1])
    img = (img * 255.0).clamp_(0.0, 255.0).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()
