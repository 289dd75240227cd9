"""Dense DFT engine (counterpart of vkresample_tpu/fft/dense.py): the
collapsed r2c chain and its row-split and quad-parity fast paths, and the
collapsed c2c chain.

The r2c pipeline (R2C_x -> fwd_y -> zero-band inv_y -> C2R_x) is a linear
map real^(h,w) -> real^(H,W).  Grouped by axis it collapses into two GEMMs
(docs/MATH.md §7-8):

    out = Ry ._y (img ._x alpha)  +  Iy ._y (img ._x beta)

alpha/beta compose the x banks (alpha is the band-limited periodic-sinc
interpolation matrix, beta its quadrature partner); Ry/Iy are the real and
imaginary parts of the composed y round trip.  Iy is rank <= 1 (only the
relocated y-Nyquist bin, which the shift moves whole, VkResample.cpp:
521-525, is unpaired), so it is factored and carried as a correction.

Three forms, by geometry:

- ``r2c_chain`` (any factor, the fractional ones and u=1 included): the two
  GEMMs above on the normalized image.
- ``r2c_rows`` (integer u >= 2): sample output rows are exact x-pass rows,
  so the y GEMM only produces the (u-1)/u non-sample rows.
- ``r2c_quad`` (u=2): sample output columns are exact too (up to a rank-1
  x-Nyquist correction), so the x GEMM only produces the odd columns, and
  the four output parity planes come out directly.

Banks are built once per geometry in f64 numpy; the GEMMs run in float32
on the device (callers keep TF32 off, pipeline/upscale.py).  The JAX
package's bf16 hi|lo and int8 digit GEMM forms are not ported.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.profiling import span


@lru_cache(maxsize=8)  # f64 staging matrices are tens of MB per geometry
def _r2c_chain_banks(
    h: int,
    w: int,
    H: int,
    W: int,
    kl_y: int,
    kh_y: int,
    kl_x: int,
    keep_nyq: bool,
    dtype: str,
):
    K = w // 2 + (1 if keep_nyq else 0)
    # x banks in f64
    n = np.arange(w)[:, None]
    k = np.arange(K)[None, :]
    ang = -2.0 * np.pi * n * k / w
    Cx, Sx = np.cos(ang), np.sin(ang)
    kk = np.arange(K)[:, None].astype(np.float64)
    nn = np.arange(W)[None, :]
    ang2 = 2.0 * np.pi * kk * nn / W
    c = np.full((K, 1), 2.0)
    c[0, 0] = 1.0
    keep = (np.arange(K) < kl_x).astype(np.float64)[:, None]
    bmask = keep.copy()
    if keep_nyq and K > w // 2:
        keep[w // 2, 0] = 1.0
        if w % 2 == 0:
            c[w // 2, 0] = 1.0  # true Nyquist: Re kept once, Im dropped
        else:
            bmask[w // 2, 0] = 1.0  # odd w: regular paired bin (c=2, Im kept)
    A = np.cos(ang2) * c * keep / w
    B = -np.sin(ang2) * c * bmask / w
    alpha = Cx @ A + Sx @ B  # (w, W)
    beta = Cx @ B - Sx @ A

    # y round-trip composite (h, H) complex
    j = np.arange(h)
    t = np.arange(h)
    Df = np.exp(-2j * np.pi * np.outer(t, j) / h)  # fwd: F[j] = sum_t U[t] e^-
    sigma = np.where(j < kl_y, j, j - h).astype(np.float64)
    keep_y = ((j < kl_y) | (j >= h - kh_y)).astype(np.float64)
    DY = (
        np.exp(2j * np.pi * np.outer(sigma, np.arange(H)) / H)
        * keep_y[:, None]
        / h
    )
    comp = Df @ DY  # (h, H)
    Ry = np.real(comp)
    Iy = np.imag(comp)

    # factor the (near-)rank-1 imaginary residue: direct cross extraction
    # first (O(h*H)), SVD as the fallback for any non-rank-1 geometry
    smax = np.abs(Iy).max()
    if smax < 1e-9:
        Y1 = np.zeros((h, 0))
        Y2 = np.zeros((0, H))
    else:
        m0 = int(np.argmax(np.abs(Iy).max(axis=0)))
        u_col = Iy[:, m0]
        # v by least-squares projection, not single-row division: the
        # projection averages the O(h*eps) rounding noise of the complex
        # Df@DY partial sums down by sqrt(h); single-row extraction at
        # h=4096 leaves ~4e-10 junk in the sample columns, which breaks the
        # y sample-row identity check in r2c_rows_banks
        v_row = (u_col @ Iy) / float(u_col @ u_col)
        # acceptance tolerance with an absolute floor for the same noise: a
        # pure relative bound spuriously rejects the exactly-rank-1 geometry
        tol = max(1e-12 * smax, 8.0 * h * np.finfo(np.float64).eps)
        if np.abs(Iy - np.outer(u_col, v_row)).max() <= tol:
            # zero sub-noise v entries (the true factor's zero columns)
            v_row = np.where(
                np.abs(v_row) * np.abs(u_col).max() <= tol, 0.0, v_row
            )
            Y1 = u_col[:, None]
            Y2 = v_row[None, :]
        else:
            U_, s_, Vt_ = np.linalg.svd(Iy, full_matrices=False)
            r = int(np.sum(s_ > 1e-10 * s_[0]))
            Y1 = U_[:, :r] * s_[:r]
            Y2 = Vt_[:r]
    return (
        alpha.astype(dtype),
        beta.astype(dtype),
        Ry.astype(dtype),
        Y1.astype(dtype),
        Y2.astype(dtype),
    )


def r2c_rows_supported(plan) -> bool:
    """Row-split fast path applies when sample output rows are exact: an
    integer factor with every y bin kept (always true for integer u on the
    reference band geometry)."""
    u = plan.integer_upscale
    return (
        plan.r2c
        and u is not None
        and u >= 2
        and plan.kept_lo_y + plan.kept_hi_y == plan.h
        and plan.H == u * plan.h
        and plan.W == u * plan.w
    )


def r2c_rows_banks(plan, dtype: str = "float64") -> dict:
    """Numpy banks of the row-split route, integer u >= 2 (the JAX
    package's r2c_rows_banks in f32 form):

      alpha     (w, W): the x bank, /255 folded in (JAX splits it into bf16
                alpha_hi + alpha_lo)
      Ymat_ns   (h + r, h(u-1)): y bank restricted to the non-sample output
                rows; rows [h, h+r) are the rank-r y-Nyquist factor Yc
      Y1n (h, r), beta (w, W): the factor's row side (/255 folded) and the
                x quadrature bank, present when r > 0
      alpha_odd (w, W/2), u=2 only: the odd output columns of alpha, for
                the quad route

    Built in f64 and cast to ``dtype``."""
    u = plan.integer_upscale
    if not r2c_rows_supported(plan):
        raise ValueError(f"row-split banks need an integer u >= 2 r2c geometry: {plan}")
    h, w, H, W = plan.h, plan.w, plan.H, plan.W
    alpha, beta, Ry, Y1, Y2 = _r2c_chain_banks(
        h, w, H, W,
        plan.kept_lo_y, plan.kept_hi_y, plan.kept_lo_x, False, "float64",
    )
    Ymat = np.concatenate([Ry, Y2], axis=0)
    y_s = Ymat.reshape(-1, h, u)[:, :, 0]
    ident = np.zeros((Ymat.shape[0], h))
    ident[:h] = np.eye(h)
    if np.abs(y_s - ident).max() >= 1e-9:
        # explicit raise (not assert): stripped under python -O, and a
        # failure here means silently wrong images
        raise ValueError("y sample-row identity failed")
    Ymat_ns = np.ascontiguousarray(
        Ymat.reshape(-1, h, u)[:, :, 1:].reshape(-1, h * (u - 1))
    )
    # fold the /255 uint8 normalization (VkResample.cpp:1644) into the x bank
    banks = {"alpha": (alpha / 255.0).astype(dtype), "Ymat_ns": Ymat_ns.astype(dtype)}
    if u == 2:
        banks["alpha_odd"] = np.ascontiguousarray(alpha[:, 1::2] / 255.0).astype(dtype)
    if Y1.shape[1]:
        banks["Y1n"] = (Y1 / 255.0).astype(dtype)
        banks["beta"] = beta.astype(dtype)
    return banks


def ycas_bank(plan) -> np.ndarray:
    """The y bank of the fused y-GEMM + CAS kernels (ops/ycas_cuda.py), u=2
    row-split geometries: YT (h, h + r) float32, built in f64, with
    YT[:, :h] = Ymat_ns[:h]^T and YT[:, h:] = Ymat_ns[h:]^T, so the odd
    output rows are O = YT[:, :h] @ U + YT[:, h:] @ T2.  The JAX package's
    ``ycasYT`` without its zero pad columns (the TPU's sublane pad RPAD)
    and without its bf16 hi|lo split ``ycasYT2``."""
    if plan.integer_upscale != 2 or not r2c_rows_supported(plan):
        raise ValueError(f"the fused y bank needs a u=2 row-split r2c geometry: {plan}")
    Yns = r2c_rows_banks(plan, "float64")["Ymat_ns"]  # (h + r, h)
    return np.ascontiguousarray(Yns.T).astype(np.float32)


def r2c_chain_banks(plan, dtype: str = "float64") -> dict:
    """Numpy banks of the collapsed r2c chain, any factor: alpha (w, W),
    Ymat = [Ry; Y2] (h + r, H) and, when r > 0, Y1 (h, r) and beta (w, W).
    Unlike the row-split banks they do not fold the /255 normalization:
    r2c_chain takes the normalized image."""
    alpha, beta, Ry, Y1, Y2 = _r2c_chain_banks(
        plan.h, plan.w, plan.H, plan.W,
        plan.kept_lo_y, plan.kept_hi_y, plan.kept_lo_x, plan.kept_hi_x > 0,
        dtype,
    )
    banks = {"alpha": alpha, "Ymat": np.concatenate([Ry, Y2], axis=0)}
    if Y1.shape[1]:
        banks["Y1"] = Y1
        banks["beta"] = beta
    return banks


def c2c_chain_banks(plan, dtype: str = "float64") -> dict:
    """Numpy banks of the collapsed c2c chain, any factor: both round
    trips are C-linear, so each axis composes into one complex matrix,
    Xc (w, W) = Dfwd_x @ DXinv_band and Yc (h, H) = Dfwd_y @ DYinv_band,
    carried as Xr, Xi, Yr, Yi and Yrpyi = Yr + Yi (Karatsuba)."""
    h, w, H, W = plan.h, plan.w, plan.H, plan.W

    def composite(n, N, kept_lo, kept_hi):
        i = np.arange(n)
        F = np.exp(-2j * np.pi * np.outer(i, i) / n)
        sigma = np.where(i < kept_lo, i, i - n).astype(np.float64)
        keep = ((i < kept_lo) | (i >= n - kept_hi)).astype(np.float64)
        Dinv = np.exp(2j * np.pi * np.outer(sigma, np.arange(N)) / N) * keep[:, None] / n
        return F @ Dinv

    Xc = composite(w, W, plan.kept_lo_x, plan.kept_hi_x)
    Yc = composite(h, H, plan.kept_lo_y, plan.kept_hi_y)
    yr, yi = np.real(Yc).astype(dtype), np.imag(Yc).astype(dtype)
    return {
        "Xr": np.real(Xc).astype(dtype),
        "Xi": np.imag(Xc).astype(dtype),
        "Yr": yr,
        "Yi": yi,
        "Yrpyi": (yr + yi).astype(dtype),
    }


def c2c_chain(x: torch.Tensor, banks: dict) -> torch.Tensor:
    """(..., h, w) normalized image -> (..., H, W) pre-CAS complex
    magnitude in CAS units: two real x GEMMs, three y GEMMs (Karatsuba)."""
    Ur = torch.matmul(x, banks["Xr"])
    Ui = torch.matmul(x, banks["Xi"])
    t1 = torch.matmul(banks["Yr"].transpose(0, 1), Ur)
    t2 = torch.matmul(banks["Yi"].transpose(0, 1), Ui)
    t3 = torch.matmul(banks["Yrpyi"].transpose(0, 1), Ur + Ui)
    yr = t1 - t2
    yi = t3 - t1 - t2
    return torch.sqrt(yr * yr + yi * yi)


def r2c_chain(x: torch.Tensor, banks: dict) -> torch.Tensor:
    """(..., h, w) normalized image -> (..., H, W) pre-CAS image in CAS
    units, via the collapsed two-GEMM chain."""
    U = torch.matmul(x, banks["alpha"])
    if "Y1" in banks:
        tcorr = torch.matmul(banks["Y1"].transpose(0, 1), x)  # (..., r, w)
        U = torch.cat([U, torch.matmul(tcorr, banks["beta"])], dim=-2)
    return torch.matmul(banks["Ymat"].transpose(0, 1), U)


def _x_nyq_corr(x_raw: torch.Tensor, banks: dict):
    """Rank-r y-Nyquist correction rows T2 (..., r, W) of the split paths,
    or None when the plan has no imaginary y residue."""
    if "Y1n" not in banks:
        return None
    tcorr = torch.matmul(banks["Y1n"].transpose(0, 1), x_raw)  # (..., r, w)
    return torch.matmul(tcorr, banks["beta"])


def r2c_x_only(x_raw: torch.Tensor, banks: dict):
    """x pass of the row-split path.  x_raw (..., h, w) holds RAW uint8
    values 0..255 (uint8 or float; /255 is folded into the banks).
    Returns (U, T2): U (..., h, W), the x-pass output, IS the sample output
    rows; T2 (..., r, W) the y-Nyquist correction rows (None when r = 0)."""
    xf = x_raw.to(banks["alpha"].dtype)
    return torch.matmul(xf, banks["alpha"]), _x_nyq_corr(xf, banks)


def r2c_rows(x_raw: torch.Tensor, banks: dict, store=None, load=None):
    """Row-split path, integer u >= 2: r2c_x_only plus the non-sample y
    GEMM.  Returns (U, O): U (..., h, W) the sample output rows, O
    (..., h(u-1), W) the non-sample rows, O[t(u-1)+k] = out[ut+k+1].

    store/load: optional pre-CAS storage codec (int16 Q2.14 in half mode).
    When given, U and O are returned stored AND the y GEMM reads the loaded
    (dequantized) stored U, as the JAX route does (dense.py:818-824)."""
    h = x_raw.shape[-2]
    U, T2 = r2c_x_only(x_raw, banks)
    if store is None:
        Us, Um = U, U
    else:
        Us = store(U)
        Um = load(Us)
    O = torch.matmul(banks["Ymat_ns"][:h].transpose(0, 1), Um)
    if T2 is not None:
        O = O + torch.matmul(banks["Ymat_ns"][h:].transpose(0, 1), T2)
    return (Us, O) if store is None else (Us, store(O))


def weave_rows(U: torch.Tensor, O: torch.Tensor, u: int) -> torch.Tensor:
    """Interleave sample rows U (..., h, W) with the non-sample row groups
    O (..., h(u-1), W) -> (..., uh, W)."""
    h, W = U.shape[-2:]
    O4 = O.reshape(O.shape[:-2] + (h, u - 1, W))
    out = torch.cat([U[..., :, None, :], O4], dim=-2)
    return out.reshape(out.shape[:-3] + (u * h, W))


def r2c_quad(x_raw: torch.Tensor, banks: dict, store=None, load=None):
    """Quad-parity fast path (u=2).  x_raw (..., h, w) holds RAW uint8
    values 0..255 (uint8 or float).  Returns the four pre-CAS parity
    planes, each (..., h, w):

      P00 = output (even rows, even cols) = x/255 - rank-1 x-Nyquist corr
      P01 = output (even rows, odd cols)  = x @ alpha_odd
      P10 = output (odd rows, even cols)  = Ymat_ns[:h]^T @ P00 (+ rank-r corr)
      P11 = output (odd rows, odd cols)   = Ymat_ns[:h]^T @ P01 (+ rank-r corr)

    Even output columns are exact samples up to the rank-1 correction
    (alpha[:, 0::2] = I - outer((-1)^i, (-1)^s)/w) and even output rows are
    exact x-pass rows, so the whole transform is one half-width x GEMM plus
    the y GEMM, and no woven image exists.

    store/load: optional pre-CAS storage codec (int16 Q2.14 in half mode).
    When given, every returned plane is stored AND the y GEMM reads the
    loaded (dequantized) even-row planes, as the JAX route does.

    GEMMs run in the banks' dtype (float32 on the slice); callers keep
    TF32 off (pipeline/upscale.py)."""
    h, w = x_raw.shape[-2:]
    with span("vkr.precas.x"):
        acc = banks["alpha_odd"].dtype
        xf = x_raw.to(acc)
        P01 = torch.matmul(xf, banks["alpha_odd"])
        signs = torch.ones(w, dtype=acc, device=xf.device)
        signs[1::2] = -1.0
        q = (xf * signs).sum(dim=-1, keepdim=True)  # (..., h, 1)
        P00 = xf * (1.0 / 255.0) - (signs * q) * (1.0 / (255.0 * w))
        t2e = t2o = None
        if "Y1n" in banks:
            # rank-r y-Nyquist correction rows: (..., r, W) split by column parity
            tcorr = torch.matmul(banks["Y1n"].transpose(0, 1), xf)  # (..., r, w)
            t2 = torch.matmul(tcorr, banks["beta"])
            t2e, t2o = t2[..., 0::2], t2[..., 1::2]
    if store is None:
        P00s, P01s, P00m, P01m = P00, P01, P00, P01
    else:
        P00s, P01s = store(P00), store(P01)
        P00m, P01m = load(P00s), load(P01s)
    with span("vkr.precas.y"):
        YmT = banks["Ymat_ns"][:h].transpose(0, 1)
        P10 = torch.matmul(YmT, P00m)
        P11 = torch.matmul(YmT, P01m)
        if t2e is not None:
            YcT = banks["Ymat_ns"][h:].transpose(0, 1)  # (h, r)
            P10 = P10 + torch.matmul(YcT, t2e)
            P11 = P11 + torch.matmul(YcT, t2o)
    if store is None:
        return P00s, P01s, P10, P11
    return P00s, P01s, store(P10), store(P11)
