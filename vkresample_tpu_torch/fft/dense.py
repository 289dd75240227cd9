"""Dense DFT engine, u=2 quad-parity subset (counterpart of
vkresample_tpu/fft/dense.py).

The r2c pipeline (R2C_x -> fwd_y -> zero-band inv_y -> C2R_x) is a linear
map real^(h,w) -> real^(H,W).  Grouped by axis it collapses into two GEMMs
(docs/MATH.md §7-8):

    out = Ry ._y (img ._x alpha)  +  Iy ._y (img ._x beta)

alpha/beta compose the x banks (alpha is the band-limited periodic-sinc
interpolation matrix, beta its quadrature partner); Ry/Iy are the real and
imaginary parts of the composed y round trip.  Iy is rank <= 1 (only the
relocated y-Nyquist bin, which the shift moves whole, VkResample.cpp:
521-525, is unpaired), so it is factored and carried as a correction.

For u=2 the sample output rows and columns are exact input samples (up to a
rank-1 x-Nyquist correction), so ``r2c_quad`` needs one GEMM over the odd
output columns and one y GEMM over the odd output rows, and emits the four
output parity planes directly.  Banks are built once per geometry in f64
numpy; the GEMMs run in float32 on the device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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
    """Numpy banks of the u=2 quad-parity route (the u=2 part of the JAX
    package's r2c_rows_banks):

      alpha_odd (w, W/2): odd output columns of the x bank, /255 folded in
      Ymat_ns   (h + r, h): y bank restricted to the odd (non-sample) output
                rows; rows [h, h+r) are the rank-r y-Nyquist factor Yc
      Y1n (h, r), beta (w, W): the factor's row side (/255 folded) and the
                x quadrature bank, present when r > 0

    Built in f64 and cast to ``dtype``."""
    u = plan.integer_upscale
    if u != 2 or not r2c_rows_supported(plan):
        raise ValueError(f"quad-parity banks need the u=2 row-split geometry: {plan}")
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
    banks = {
        "alpha_odd": np.ascontiguousarray(alpha[:, 1::2] / 255.0).astype(dtype),
        "Ymat_ns": Ymat_ns.astype(dtype),
    }
    if Y1.shape[1]:
        banks["Y1n"] = (Y1 / 255.0).astype(dtype)
        banks["beta"] = beta.astype(dtype)
    return banks


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
