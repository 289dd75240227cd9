"""Fused y GEMM + CAS + quantize kernels (u=2): their wrappers and plain
PyTorch versions.

Counterparts of vkresample_tpu/ops/ycas_pallas.py:

  K8 ycas_parity_u2  y GEMM + rows-parity CAS -> (E, D) planes   csrc/ycas.cu
  K9 ycas_u2         y GEMM + rows-parity CAS -> woven image     csrc/ycas.cu

Both take the u=2 rows route's x-pass output (fft/dense.py::r2c_x_only):
the sample rows U (..., h, W), int16 Q2.14 or float32, the rank-r
y-Nyquist correction rows T2 (..., r, W) float32 or None, and the y bank YT
(h, h + r) float32 of fft/dense.py::ycas_bank.  They compute the odd output
rows O = YT[:, :h] @ U + YT[:, h:] @ T2 in float32 (U dequantized, O never
Q2.14-rounded) and the CAS of the woven pair (U, O), so neither O nor the
woven pre-CAS image reaches device memory.  On the card the GEMM runs on
the tensor cores in 3xTF32 (each operand split into TF32 hi + lo, lo.hi +
hi.lo + hi.hi summed in float32; csrc/ycas.cu), within the float32
GEMM's error of the float64 product; the plain versions use torch.matmul
in float32.  The kernels read the bank padded, ycas_bank_padded(YT), which
the wrappers make once per bank tensor and keep on it.  Every h, W >= 1
and r >= 0 runs: the TPU kernels' strip width, band height, halo and
support gate are TPU tiling and have no counterpart.  No route calls them (as in the JAX package): they are
entry points of their own, held against the rows route (y GEMM + K2).

Each wrapper runs its kernel on CUDA tensors (on the current stream; a
launch error raises) and its plain version on CPU tensors, and counts its
kernel launches in ``.launches``.
"""
from __future__ import annotations

import torch

from .cas import from_i16_storage
from .cas_cuda import _check, _launch, cas_parity_planes_u2_reference
from .weave import weave_rows_u8


def _check_ycas(U, T2, YT) -> int:
    """Raise on inputs the kernels do not take; returns r."""
    _check("fused y CAS", (U,))
    h, W = U.shape[-2:]
    if YT.dtype != torch.float32 or YT.dim() != 2 or YT.shape[0] != h or YT.shape[1] < h:
        raise ValueError(f"YT must be float32 (h, h + r) with h = {h}, got "
                         f"{YT.dtype} {tuple(YT.shape)}")
    r = YT.shape[1] - h
    if T2 is None:
        if r:
            raise ValueError(f"YT has {r} correction columns but T2 is None")
    elif (T2.dtype != torch.float32 or tuple(T2.shape) != U.shape[:-2] + (r, W)
          or T2.device != U.device):
        raise ValueError(f"T2 must be float32 {U.shape[:-2] + (r, W)} on {U.device}, got "
                         f"{T2.dtype} {tuple(T2.shape)} on {T2.device}")
    if YT.device != U.device:
        raise ValueError(f"YT lies on {YT.device}, U on {U.device}")
    if not YT.is_contiguous() or (T2 is not None and not T2.is_contiguous()):
        raise ValueError("fused y CAS inputs must be contiguous")
    return r


def ycas_odd_rows_reference(U, T2, YT):
    """The y GEMM of the plain versions: (load(U), O) with O = YT[:, :h] @
    load(U) + YT[:, h:] @ T2 in float32 (torch.matmul)."""
    _check_ycas(U, T2, YT)
    h = U.shape[-2]
    Uf = from_i16_storage(U) if U.dtype == torch.int16 else U
    O = torch.matmul(YT[:, :h], Uf)
    if T2 is not None:
        O = O + torch.matmul(YT[:, h:], T2)
    return Uf, O


def ycas_parity_u2_reference(U, T2, YT, sharpen: float):
    """Plain PyTorch version of K8, on any device: the y GEMM, then the
    rows-parity CAS of (load(U), O) -> (E, D) uint8, each (..., h, W)."""
    return cas_parity_planes_u2_reference(*ycas_odd_rows_reference(U, T2, YT), sharpen)


def ycas_u2_reference(U, T2, YT, sharpen: float) -> torch.Tensor:
    """Plain PyTorch version of K9, on any device: K8's plain version,
    woven to (..., 2h, W) uint8."""
    return weave_rows_u8(*ycas_parity_u2_reference(U, T2, YT, sharpen))


def ycas_bank_padded(YT: torch.Tensor) -> torch.Tensor:
    """The y bank YT (h, h + r) float32 as K8 and K9 read it: (h, hp + rp)
    float32 on YT's device, hp and rp = h and r rounded up to 4, YT's first
    h columns at 0 .. h-1 and its last r at hp .. hp+r-1, zero elsewhere,
    so every row and both column blocks start 16 bytes aligned."""
    h, K = YT.shape
    r = K - h
    hp, rp = -(-h // 4) * 4, -(-r // 4) * 4
    out = torch.zeros((h, hp + rp), dtype=torch.float32, device=YT.device)
    out[:, :h] = YT[:, :h]
    out[:, hp:hp + r] = YT[:, h:]
    return out


def _bank_padded(YT: torch.Tensor) -> torch.Tensor:
    """ycas_bank_padded(YT), made once per bank tensor and kept on it (made
    again if YT was changed in place)."""
    kept = getattr(YT, "_vkr_ycas_padded", None)
    if kept is None or kept[0] != YT._version:
        kept = (YT._version, ycas_bank_padded(YT))
        YT._vkr_ycas_padded = kept
    return kept[1]


def _ycas_launch(entry: str, U, T2, YT, outs, r: int, sharpen: float) -> None:
    h, W = U.shape[-2:]
    _launch(entry, U.device, U.data_ptr(), None if T2 is None else T2.data_ptr(),
            _bank_padded(YT).data_ptr(), *(o.data_ptr() for o in outs), U.numel() // (h * W),
            h, W, r, int(U.dtype == torch.int16), float(sharpen))


def ycas_parity_u2(U, T2, YT, sharpen: float):
    """K8, fused y GEMM + rows-parity CAS (u=2): U (..., h, W) int16 Q2.14
    or float32, T2 (..., r, W) float32 or None, YT (h, h + r) float32 ->
    the uint8 even-row and odd-row planes (E, D), each (..., h, W).  CUDA
    tensors go through csrc/ycas.cu, CPU tensors take the plain version."""
    r = _check_ycas(U, T2, YT)
    if U.device.type == "cpu":
        return ycas_parity_u2_reference(U, T2, YT, sharpen)
    E, D = (torch.empty(U.shape, dtype=torch.uint8, device=U.device) for _ in range(2))
    if U.numel() == 0:
        return E, D
    _ycas_launch("vkr_ycas_parity_u2", U, T2, YT, (E, D), r, sharpen)
    ycas_parity_u2.launches += 1
    return E, D


ycas_parity_u2.launches = 0


def ycas_u2(U, T2, YT, sharpen: float) -> torch.Tensor:
    """K9, fused y GEMM + CAS (u=2) to the woven image: the inputs of
    ycas_parity_u2 -> (..., 2h, W) uint8.  CUDA tensors go through
    csrc/ycas.cu, CPU tensors take the plain version."""
    r = _check_ycas(U, T2, YT)
    if U.device.type == "cpu":
        return ycas_u2_reference(U, T2, YT, sharpen)
    h, W = U.shape[-2:]
    out = torch.empty(U.shape[:-2] + (2 * h, W), dtype=torch.uint8, device=U.device)
    if U.numel() == 0:
        return out
    _ycas_launch("vkr_ycas_u2", U, T2, YT, (out,), r, sharpen)
    ycas_u2.launches += 1
    return out


ycas_u2.launches = 0
