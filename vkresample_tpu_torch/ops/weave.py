"""Device-side uint8 parity weaves (counterpart of
vkresample_tpu/ops/weave.py).

The JAX package packs column pairs into uint16 lanes because a column
interleave is a pathological layout op on a TPU; on a GPU either weave is
one strided copy, so both are written as stack + reshape.
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
