"""Device-side parity weaves (counterpart of vkresample_tpu/ops/weave.py).

The JAX package packs column pairs into uint16 lanes because a column
interleave is a pathological layout op on a TPU; on a GPU every weave is
one strided copy, so all are written as stack + reshape.
"""
from __future__ import annotations

import torch


def _check_u8(*planes) -> None:
    if any(p.dtype != torch.uint8 for p in planes):
        raise TypeError("the parity weaves take uint8 planes")


def weave_rows_u8(top: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """(..., h, W) + (..., h, W) uint8 -> (..., 2h, W) with out[..., 0::2, :]
    = top and out[..., 1::2, :] = bot."""
    _check_u8(top, bot)
    h, W = top.shape[-2:]
    return torch.stack([top, bot], dim=-2).reshape(top.shape[:-2] + (2 * h, W))


def weave_cols_u8(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(..., h, w) + (..., h, w) uint8 -> (..., h, 2w) with out[..., 0::2]
    = even and out[..., 1::2] = odd."""
    _check_u8(even, odd)
    return torch.stack([even, odd], dim=-1).reshape(even.shape[:-1] + (2 * even.shape[-1],))


def weave_quad_u8(P00, P01, P10, P11) -> torch.Tensor:
    """Four uint8 quad-parity planes (..., h, w), p[row parity][col
    parity], -> woven (..., 2h, 2w) uint8."""
    return weave_rows_u8(weave_cols_u8(P00, P01), weave_cols_u8(P10, P11))


def weave_grid(planes, u: int) -> torch.Tensor:
    """u*u grid-parity planes of any one dtype (row-major (ry, rx), each
    (..., h, w)) -> woven (..., u*h, u*w), out[..., ry::u, rx::u] =
    planes[ry*u + rx]."""
    if len(planes) != u * u:
        raise ValueError(f"expected {u * u} planes for u={u}, got {len(planes)}")
    lead, (h, w) = planes[0].shape[:-2], planes[0].shape[-2:]
    g = torch.stack(tuple(planes), dim=-3).reshape(lead + (u, u, h, w))
    g = g.movedim(-4, -2).movedim(-4, -1)  # (..., h, ry, w, rx)
    return g.reshape(lead + (u * h, u * w))


def weave_grid_u8(planes, u: int) -> torch.Tensor:
    """u*u uint8 grid-parity planes (row-major (ry, rx), each (..., h, w))
    -> woven (..., u*h, u*w) uint8."""
    _check_u8(*planes)
    return weave_grid(planes, u)
