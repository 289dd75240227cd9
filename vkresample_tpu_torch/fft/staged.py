"""Staged circulant-convolution transform: the big-tier any-size engine
(counterpart of vkresample_tpu/fft/staged.py).

The zero-pad upscale by u = p/q restricted to the output lattice
(p*m + ry, p*n + rx) is a pair of real circular convolutions of the input,
one per axis, sampled at stride q (docs/MATH.md §7-11).  Each length-n
convolution runs as a two-level Cooley-Tukey factorization n = n1*n2 in
THREE small contractions, with the twiddles and the kernel's eigenvalues
folded into the middle stage's per-k2 banks:

  t = t1 + n1*t2,  k = k2 + n2*k1
  S1 (fwd DFT over t2):   Y[t1,k2]  = sum_t2  x[t1+n1*t2] W2[t2,k2]
  S2 (per-k2 n1 x n1):    Z[t1',k2] = sum_t1  M[k2][t1,t1'] Y[t1,k2]
  S3 (inv DFT over k2):   out[t1'+n1*t2'] = (1/n2) sum_k2 Z[t1',k2] e^{+2pi i t2' k2/n2}

Bank bytes are O(n*n1) instead of the dense tier's O(n^2), so there is no
size cap.  Three forms use it:

  r2c_quad_staged   r2c u=2: the four quad-parity planes (K1 consumes them)
  r2c_grid_staged   r2c integer u >= 2 or a fraction p/q: p^2 phase planes
                    (K4 consumes them)
  c2c_grid_staged   c2c integer u >= 2 or p/q: p^2 magnitude planes

In each, the ry = 0 planes are the identity y roundtrip, the rx = 0 planes
exact samples less a rank-1 x-Nyquist correction, and the relocated
y-Nyquist bin leaves a rank-1 imaginary residue that a one-row colsum, a
chi convolution and a DC-bin injection (ynyq_dc_or_post) carry.

The complex stage arithmetic rides as an explicit size-2 axis in the
banks, so each stage is one real einsum.  The banks are built in f64 numpy
and the stages run as ``torch.einsum`` in the banks' dtype: float32 (callers
keep TF32 off, pipeline/upscale.py) or float64 for -p 1, where float64 banks
give an fp64 transform with no other change.  The JAX package runs the f32
stages at bf16x3 on its matrix unit; here they are full fp32.  Its TPU
layout and A/B options change layout or speed on the TPU, never the result,
and are not ported: the factored and rows4d layouts, the composition
variants, the i16/bf16/bf16c intermediate codecs (and the banks' qb/dc0
entries that serve them) and the staged precision knob.
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch

# ---------------------------------------------------------------------------
# kernel columns and banks (f64 numpy)
# ---------------------------------------------------------------------------


def _odd_kernel(n: int, g: np.ndarray) -> np.ndarray:
    """c[d] = (1/n) sum_k g[k] e^{i pi sigma(k) (2d+1) / n} for the
    half-sample-offset (odd output) lattice, as one length-n ifft."""
    return np.fft.ifft(g)


def y_kernel(h: int, kept_lo: int, kept_hi: int):
    """Odd-output-row y kernel c (real, (h,)) of the u=2 band and the
    rank-1 relocated y-Nyquist imaginary residue a0, Iy_odd[t, s] = a0 *
    (-1)^(s-t) (a0 == 0 when every kept bin is +/- paired)."""
    j = np.arange(h)
    sigma = np.where(j < kept_lo, j, j - h).astype(np.float64)
    keep = (j < kept_lo) | (j >= h - kept_hi)
    g = keep.astype(np.float64) * np.exp(1j * np.pi * sigma / h)
    c = _odd_kernel(h, g)
    im = np.imag(c)
    a0 = float(im[0])
    if np.abs(im - a0 * (-1.0) ** np.arange(h)).max() > 1e-12:
        raise ValueError("y imaginary residue is not rank-1")
    return np.real(c), a0


def x_kernels(w: int, kept_lo: int):
    """The three real x-axis kernels of the u=2 band (x-Nyquist dropped):
    psi_o (odd output columns), chi_o and chi_e (the odd- and even-column
    quadrature partners that couple to the y-Nyquist residue)."""
    k = np.arange(w)
    sigma = np.where(k < kept_lo, k, k - w).astype(np.float64)
    keep = ((k < kept_lo) | (k > w - kept_lo)).astype(np.float64)
    g_alpha = keep * np.exp(1j * np.pi * sigma / w)
    g_beta = 1j * np.sign(sigma) * g_alpha
    psi_o = _odd_kernel(w, g_alpha)
    chi_o = _odd_kernel(w, g_beta)
    chi_e = np.fft.ifft(1j * np.sign(sigma) * keep)  # even lattice: no half-sample phase
    for v in (psi_o, chi_o, chi_e):
        if np.abs(np.imag(v)).max() > 1e-12:
            raise ValueError("x kernel not real - band not symmetric")
    return np.real(psi_o), np.real(chi_o), np.real(chi_e)


def phase_y_kernel(h: int, kept_lo: int, kept_hi: int, ry: int, u):
    """Per-phase kernel for factor u (int, or Fraction p/q): the composed
    roundtrip restricted to output rows p*m + ry is circulant-at-stride-q
    with

      c_ry(d) = (1/h) sum_j keep(j) e^{2 pi i sigma(j) (d + ry/u) / h}

    Returns (real kernel (h,), a0): the imaginary residue is the pure
    relocated-Nyquist tone a0 * (-1)^d (a0 = 0 at ry = 0)."""
    uf = Fraction(u)
    p, q = uf.numerator, uf.denominator
    j = np.arange(h)
    sigma = np.where(j < kept_lo, j, j - h).astype(np.float64)
    keep = (j < kept_lo) | (j >= h - kept_hi)
    g = keep.astype(np.float64) * np.exp(2j * np.pi * sigma * (ry * q) / (p * h))
    c = np.fft.ifft(g)
    im = np.imag(c)
    a0 = float(im[0])
    if np.abs(im - a0 * (-1.0) ** np.arange(h)).max() > 1e-12:
        raise ValueError("y imaginary residue is not rank-1")
    return np.real(c), a0


def phase_x_kernels(w: int, kept_lo: int, rx: int, u):
    """Per-phase x kernels for factor u (int or Fraction p/q): output
    columns p*m + rx, sampled at stride q.

      psi_rx(d) = (1/w) sum_sym keep e^{2 pi i sigma (d + rx/u) / w}
      chi_rx(d) = the same with i*sign(sigma) weights

    Both are exactly real (symmetric band, Nyquist dropped); x_kernels is
    the u=2 specialization (psi_1, chi_1, chi_0)."""
    uf = Fraction(u)
    p, q = uf.numerator, uf.denominator
    k = np.arange(w)
    sigma = np.where(k < kept_lo, k, k - w).astype(np.float64)
    keep = ((k < kept_lo) | (k > w - kept_lo)).astype(np.float64)
    g_alpha = keep * np.exp(2j * np.pi * sigma * (rx * q) / (p * w))
    g_beta = 1j * np.sign(sigma) * g_alpha
    psi = np.fft.ifft(g_alpha)
    chi = np.fft.ifft(g_beta)
    for v in (psi, chi):
        if np.abs(np.imag(v)).max() > 1e-12:
            raise ValueError("x kernel not real - band not symmetric")
    return np.real(psi), np.real(chi)


def split_factors(n: int, prefer: int = None, multiple_of: int = 1):
    """(n1, n2) with n1 the divisor of n closest to `prefer` (ties toward
    the larger), n1 >= 8, n2 = n // n1 >= 4 and multiple_of | n1; None
    when no such split exists.  Default prefer: sqrt(n) clamped to
    [8, 64]."""
    if prefer is None:
        prefer = max(8, min(64, int(round(float(np.sqrt(n))))))
    best = None
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d:
            continue
        for cand in (d, n // d):
            if cand < 8 or n // cand < 4 or cand % multiple_of:
                continue
            score = (abs(cand - prefer), -cand)
            if best is None or score < best[0]:
                best = (score, cand)
    if best is None:
        return None
    return best[1], n // best[1]


def x_split_prefer(decimate: int = 1, n: int = None) -> int:
    """Preferred middle factor n1 of the x (lanes) convolutions: 128*q,
    doubled while it divides n and n/n1 > 64; for widths that 128*q does
    not divide, the divisor in [64q, 320q] whose two stage views (n1 in,
    n1/q out) pad least to 128 columns (ties toward 128q, then larger).
    The JAX package picked it for its 128-lane layout; it is kept so both
    packages build the same banks."""
    n1 = 128 * decimate
    if n:
        if n % n1 == 0:
            while n % (2 * n1) == 0 and n // n1 > 64:
                n1 *= 2
        else:
            best = None
            lo, hi = 64 * decimate, 320 * decimate
            for d in range(decimate, n + 1, decimate):
                if n % d or d < max(8, lo) or d > hi or n // d < 4:
                    continue
                waste = (-d % 128) / d + (-(d // decimate) % 128) / (d // decimate)
                score = (round(waste, 6), abs(d - 128 * decimate), -d)
                if best is None or score < best[0]:
                    best = (score, d)
            if best is not None:
                n1 = best[1]
    return n1


def conv_banks(kernel: np.ndarray, prefix: str, n1: int = None, dtype: str = "float32",
               prefer: int = None, decimate: int = 1) -> dict:
    """Banks of one staged circular convolution with the real kernel
    column: out[s] = sum_t kernel[(s-t) mod n] x[t].

      b1 (n2, 2, k2h)          [cos, sin] of the forward t2-DFT, bins
                               k2 in [0, n2/2] (the input is real)
      m  (k2h, 2, n1, 2, nd)   complex M[k2] as a 2x2 real block
      b3 (2, k2h, n2)          weighted real part of the inverse k2-DFT

    decimate=q keeps only outputs s = q*m (q | n1): the middle stage's t1'
    axis is cut to multiples of q, nd = n1/q, and conv_apply_* return the
    n/q decimated outputs in order."""
    n = kernel.shape[0]
    if n1 is None:
        split = split_factors(n, prefer, multiple_of=decimate)
        if split is None:
            raise ValueError(f"no usable Cooley-Tukey split for n={n}")
        n1, n2 = split
    else:
        n2 = n // n1
    if n1 % decimate:
        raise ValueError(f"decimate {decimate} must divide n1 {n1}")
    lam = np.fft.fft(kernel.astype(np.float64))  # circulant eigenvalues
    t2 = np.arange(n2)
    w2f = np.exp(-2j * np.pi * np.outer(t2, t2) / n2)  # (t2, k2)
    w2i = np.exp(2j * np.pi * np.outer(t2, t2) / n2) / n2  # (k2, t2')
    t1 = np.arange(n1)
    w1f = np.exp(-2j * np.pi * np.outer(t1, t1) / n1)  # (t1, k1)
    w1i = np.exp(2j * np.pi * np.outer(t1, t1) / n1) / n1  # (k1, t1')
    lam2 = lam.reshape(n1, n2)  # (k1, k2): k = k2 + n2*k1
    tw = np.exp(-2j * np.pi * np.outer(t1, t2) / n)  # (t1, k2) twiddle
    M = np.einsum("ac,ak,kc,kb,bc->cab", tw, w1f, lam2, w1i, np.conj(tw))
    kh = n2 // 2 + 1
    b1 = np.stack([np.real(w2f), np.imag(w2f)], axis=1)[:, :, :kh]
    if decimate > 1:
        M = M[:, :, ::decimate]
    nd = n1 // decimate
    mb = np.empty((kh, 2, n1, 2, nd))
    mr, mi = np.real(M[:kh]), np.imag(M[:kh])
    mb[:, 0, :, 0, :] = mr
    mb[:, 1, :, 0, :] = -mi
    mb[:, 0, :, 1, :] = mi
    mb[:, 1, :, 1, :] = mr
    pair_w = np.full((kh, 1), 2.0)  # Hermitian pairs of the half spectrum
    pair_w[0, 0] = 1.0
    if n2 % 2 == 0:
        pair_w[n2 // 2, 0] = 1.0
    b3 = np.stack([np.real(w2i[:kh]) * pair_w, -np.imag(w2i[:kh]) * pair_w], axis=0)
    return {
        prefix + "b1": b1.astype(dtype),
        prefix + "m": mb.astype(dtype),
        prefix + "b3": b3.astype(dtype),
    }


# ---------------------------------------------------------------------------
# applying the banks
# ---------------------------------------------------------------------------


def conv_apply_rows(x: torch.Tensor, banks: dict, prefix: str, load=None, epilogue=None,
                    dc_add=None):
    """Staged circular convolution over axis -2 of a real (..., n, L)
    tensor -> (..., n/q, L).

    load: storage decode applied after the row-split reshape (x arrives
    stored, e.g. int16 Q2.14).
    dc_add: optional (..., nd, L) term injected into the DC bin's real part
    between S2 and S3; since b3[0, 0, e] = 1/n2 for every e, that is a
    broadcast add of dc_add[d, L] over the n2 output row groups, applied
    after S3 (the rank-1 y-Nyquist correction, ynyq_dc_or_post).
    epilogue: elementwise function on the output's pre-flatten view
    (..., e, d, L), e of size n2 and d of size nd, output row e*nd + d,
    applied after dc_add; terms indexed by output row must be shaped (n2,
    nd, 1) by the caller."""
    b1, mb, b3 = banks[prefix + "b1"], banks[prefix + "m"], banks[prefix + "b3"]
    n2, n1, nd = b1.shape[0], mb.shape[2], mb.shape[4]
    lead, L = x.shape[:-2], x.shape[-1]
    x = x.reshape(lead + (n2, n1, L))
    if load is not None:
        x = load(x)
    y = torch.einsum("ajc,...abL->...jcbL", b1, x)  # S1: (..., 2, k2h, n1, L)
    y = torch.einsum("cjbkd,...jcbL->...kcdL", mb, y)  # S2: (..., 2, k2h, nd, L)
    y = torch.einsum("kce,...kcdL->...edL", b3, y)  # S3: (..., n2, nd, L)
    if dc_add is not None:
        y = y + dc_add[..., None, :, :]
    if epilogue is not None:
        y = epilogue(y)
    return y.reshape(lead + (n2 * nd, L))


def conv_apply_lanes(x: torch.Tensor, banks: dict, prefix: str):
    """Staged circular convolution over axis -1 of a real (..., n) tensor
    -> (..., n/q)."""
    b1, mb, b3 = banks[prefix + "b1"], banks[prefix + "m"], banks[prefix + "b3"]
    n2, n1, nd = b1.shape[0], mb.shape[2], mb.shape[4]
    lead = x.shape[:-1]
    x = x.reshape(lead + (n2, n1))
    y = torch.einsum("ajc,...ab->...jcb", b1, x)
    y = torch.einsum("cjbkd,...jcb->...kcd", mb, y)
    y = torch.einsum("kce,...kcd->...ed", b3, y)
    return y.reshape(lead + (n2 * nd,))


# ---------------------------------------------------------------------------
# r2c: the rank-1 pieces shared by the quad and grid forms
# ---------------------------------------------------------------------------


def _xnyq_colsum(x_raw: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """The signed row sums q = sum_j x[..., j] (-1)^j, (..., h, 1), of the
    rank-1 x-Nyquist correction.  On a raw uint8 image they are summed in
    integers, exactly (w*255 < 2^31), and rounded to the accumulation dtype
    once; a float image sums in its own dtype."""
    w = x_raw.shape[-1]
    if x_raw.dtype == torch.uint8:
        isign = _signs(w, 1, torch.int32, xf.device)
        return (x_raw.to(torch.int32) * isign).sum(dim=-1, keepdim=True).to(xf.dtype)
    return (xf * _signs(w, 1, xf.dtype, xf.device)).sum(dim=-1, keepdim=True)


def ynyq_dc_or_post(yc, n1: int, nd: int, qd: int, h_out: int):
    """Rank-1 relocated-y-Nyquist injection factors, the one place the
    even/odd-n1 rule lives (r2c_quad_staged and r2c_grid_staged).

    Returns (dc_factor, post_factor), exactly one not None; the caller
    multiplies it by the chi-convolved correction row t.  Even n1 (= qd*nd):
    the output-row sign (-1)^(qd*(d + nd*t2')) is (-1)^(qd*d), so the
    correction injects into the DC bin of the small spectral intermediate
    (conv_apply_rows' dc_add).  Odd n1: the sign depends on the outer row
    index, so it is added afterwards over the h_out output rows."""
    if n1 % 2 == 0:
        return yc * _signs(nd, qd, yc.dtype, yc.device)[:, None], None
    return None, yc * _signs(h_out, qd, yc.dtype, yc.device)[:, None]


# ---------------------------------------------------------------------------
# r2c u=2 quad-parity form
# ---------------------------------------------------------------------------


def staged_supported(plan) -> bool:
    """The staged quad form takes u=2 r2c plans with even dims and usable
    Cooley-Tukey splits on both axes: any such size, 128-aligned or not."""
    from .dense import r2c_rows_supported

    return (
        plan.r2c
        and plan.integer_upscale == 2
        and r2c_rows_supported(plan)
        and plan.h % 2 == 0
        and plan.w % 2 == 0
        and split_factors(plan.h) is not None
        and split_factors(plan.w) is not None
    )


def r2c_quad_staged_banks(plan, dtype: str = "float32") -> dict:
    """Banks of the staged u=2 quad transform (detect: "stx_b1" present):
    the x conv stx_ (psi_o, /255 folded in), the y conv sty_, and where the
    band leaves a y-Nyquist residue (a0 != 0) its rank-1 pieces: st_y1n
    ((-1)^t / 255, (h, 1)), st_yc (a0) and the chi convs stbo_ / stbe_.
    dtype "float64" serves -p 1."""
    if not staged_supported(plan):
        raise ValueError(f"plan has no staged quad route: {plan}")
    h, w = plan.h, plan.w
    cy, a0 = y_kernel(h, plan.kept_lo_y, plan.kept_hi_y)
    psi_o, chi_o, chi_e = x_kernels(w, plan.kept_lo_x)
    banks = conv_banks(psi_o / 255.0, "stx_", dtype=dtype, prefer=x_split_prefer(n=w))
    banks.update(conv_banks(cy, "sty_", dtype=dtype))
    if a0 != 0.0:
        banks["st_y1n"] = (((-1.0) ** np.arange(h))[:, None] / 255.0).astype(dtype)
        banks["st_yc"] = np.asarray(a0, dtype)
        # the correction convs see one row a plane: a small middle factor
        banks.update(conv_banks(chi_o, "stbo_", dtype=dtype, prefer=16))
        banks.update(conv_banks(chi_e, "stbe_", dtype=dtype, prefer=16))
    return banks


def r2c_quad_staged(x_raw: torch.Tensor, banks: dict, store=None, load=None):
    """Quad-parity u=2 transform on staged convolutions, the contract of
    dense.r2c_quad: x_raw (..., C, h, w) holds raw pixel values 0..255
    (uint8, or float on the woven path); returns the four pre-CAS parity
    planes P00, P01, P10, P11, each (..., C, h, w) in CAS units.

      P00 = x/255 - rank-1 x-Nyquist correction (exact samples)
      P01 = x (x) psi_o along the rows' columns (the x conv)
      P10, P11 = the y conv of P00, P01 (+ the rank-1 y-Nyquist term)

    store/load: optional pre-CAS storage codec (int16 Q2.14 in half mode):
    P00 and P01 are stored once, the y convs decode them inside their
    row-split view, and every returned plane is stored."""
    h, w = x_raw.shape[-2:]
    acc = banks["stx_b1"].dtype
    xf = x_raw.to(acc)
    P01 = conv_apply_lanes(xf, banks, "stx_")
    q = _xnyq_colsum(x_raw, xf)
    P00 = xf * (1.0 / 255.0) - (_signs(w, 1, acc, xf.device) * q) * (1.0 / (255.0 * w))
    dc_e = dc_o = post = None
    if "st_y1n" in banks:
        tcorr = torch.matmul(banks["st_y1n"].transpose(0, 1), xf)  # (..., 1, w)
        t2o = conv_apply_lanes(tcorr, banks, "stbo_")
        t2e = conv_apply_lanes(tcorr, banks, "stbe_")
        n1 = banks["sty_m"].shape[2]
        dcf, post = ynyq_dc_or_post(banks["st_yc"], n1, n1, 1, h)
        if dcf is not None:
            dc_e, dc_o = dcf * t2e, dcf * t2o
    if store is not None:
        P00, P01 = store(P00), store(P01)
    P10 = conv_apply_rows(P00, banks, "sty_", load=load, dc_add=dc_e)
    P11 = conv_apply_rows(P01, banks, "sty_", load=load, dc_add=dc_o)
    if post is not None:
        P10 = P10 + post * t2e
        P11 = P11 + post * t2o
    if store is None:
        return P00, P01, P10, P11
    return P00, P01, store(P10), store(P11)


# ---------------------------------------------------------------------------
# r2c grid-parity form (integer u >= 2 or a fraction p/q): p^2 phase planes
# ---------------------------------------------------------------------------


def frac_params(plan):
    """(p, q) of the fractional r2c grid route, or None.  u = p/q is the
    exact rational of the integer geometry (_exact_fraction); the route
    needs q | h and q | w, even dims, the plan's C-float band edges equal
    to the rational keep set (every y bin kept, the x band [0, w/2) with
    the Nyquist dropped) and splits with q | n1 on both axes."""
    if not plan.r2c or plan.integer_upscale is not None:
        return None
    params = _exact_fraction(plan)
    if params is None:
        return None
    p, q = params
    if (
        plan.h % 2
        or plan.w % 2
        or plan.kept_lo_y + plan.kept_hi_y != plan.h
        or plan.kept_lo_x != plan.w // 2
        or plan.kept_hi_x != 0
        or split_factors(plan.h, multiple_of=q) is None
        or split_factors(plan.w, multiple_of=q) is None
    ):
        return None
    return p, q


def grid_params(plan):
    """(p, q) of the r2c grid route: (u, 1) for an integer u >= 2 on the
    row-split geometry with even dims and splits, frac_params otherwise."""
    from .dense import r2c_rows_supported

    if (
        plan.r2c
        and plan.integer_upscale is not None
        and plan.integer_upscale >= 2
        and r2c_rows_supported(plan)
        and plan.h % 2 == 0
        and plan.w % 2 == 0
        and split_factors(plan.h) is not None
        and split_factors(plan.w) is not None
    ):
        return plan.integer_upscale, 1
    return frac_params(plan)


def grid_supported(plan) -> bool:
    return grid_params(plan) is not None


def grid_u(banks: dict):
    """Phase count p of an r2c grid bank set, None when not one."""
    if "sgx1_b1" not in banks:
        return None
    u = 2
    while f"sgx{u}_b1" in banks:
        u += 1
    return u


def r2c_grid_staged_banks(plan, dtype: str = "float32") -> dict:
    """Banks of the r2c grid transform (detect: "sgx1_b1" present):
    sgy{ry}_ and sgx{rx}_ for phases 1..p-1 (the x convs fold /255 in, a
    fraction p/q folds its stride-q decimation into the middle banks), and
    where the band leaves a y-Nyquist residue the rank-1 pieces sg_y1n,
    sg_yc{ry} and the chi convs sgb{rx}_ for rx = 0..p-1."""
    params = grid_params(plan)
    if params is None:
        raise ValueError(f"plan has no r2c grid route: {plan}")
    p, q = params
    uf = Fraction(p, q)
    h, w = plan.h, plan.w
    banks, a0s = {}, {}
    for ry in range(1, p):
        cy, a0s[ry] = phase_y_kernel(h, plan.kept_lo_y, plan.kept_hi_y, ry, uf)
        banks.update(conv_banks(cy, f"sgy{ry}_", dtype=dtype, decimate=q))
    for rx in range(1, p):
        psi, _ = phase_x_kernels(w, plan.kept_lo_x, rx, uf)
        banks.update(conv_banks(psi / 255.0, f"sgx{rx}_", dtype=dtype, decimate=q,
                                prefer=x_split_prefer(q, n=w)))
    if any(a0 != 0.0 for a0 in a0s.values()):
        banks["sg_y1n"] = (((-1.0) ** np.arange(h))[:, None] / 255.0).astype(dtype)
        for ry in range(1, p):
            banks[f"sg_yc{ry}"] = np.asarray(a0s[ry], dtype)
        for rx in range(p):
            _, chi = phase_x_kernels(w, plan.kept_lo_x, rx, uf)
            banks.update(conv_banks(chi, f"sgb{rx}_", dtype=dtype, prefer=16 * q, decimate=q))
    return banks


def r2c_grid_staged(x_raw: torch.Tensor, banks: dict, store=None, load=None):
    """r2c grid transform.  x_raw (..., C, h, w) holds raw pixel values
    0..255; returns the p^2 pre-CAS phase planes row-major (P[0][0], ...,
    P[p-1][p-1]), each (..., C, h/q, w/q) in CAS units (q = 1 for integer
    factors).  The storage contract of r2c_quad_staged.

    The x-phase planes are computed once and shared by every y phase: the
    ry = 0 planes are their row subsamples at stride q (the identity y
    roundtrip), the others their y convs, decimated for a fraction."""
    u = grid_u(banks)
    qd = banks["sgy1_m"].shape[2] // banks["sgy1_m"].shape[4]
    h, w = x_raw.shape[-2:]
    acc = banks["sgx1_b1"].dtype
    dev = banks["sgx1_b1"].device
    xf = x_raw.to(acc)
    q = _xnyq_colsum(x_raw, xf)
    xs = xf if qd == 1 else xf[..., ::qd]
    P0 = [xs * (1.0 / 255.0) - (_signs(w // qd, qd, acc, dev) * q) * (1.0 / (255.0 * w))]
    P0 += [conv_apply_lanes(xf, banks, f"sgx{rx}_") for rx in range(1, u)]
    tc = None
    if "sg_y1n" in banks:
        tcorr = torch.matmul(banks["sg_y1n"].transpose(0, 1), xf)  # (..., 1, w)
        tc = [conv_apply_lanes(tcorr, banks, f"sgb{rx}_") for rx in range(u)]
    if store is not None:
        P0 = [store(p) for p in P0]
    planes = list(P0) if qd == 1 else [p[..., ::qd, :].contiguous() for p in P0]
    for ry in range(1, u):
        mb = banks[f"sgy{ry}_m"]
        dcf = postf = None
        if tc is not None:
            dcf, postf = ynyq_dc_or_post(banks[f"sg_yc{ry}"], mb.shape[2], mb.shape[4], qd,
                                         h // qd)
        for rx in range(u):
            P = conv_apply_rows(P0[rx], banks, f"sgy{ry}_", load=load,
                                dc_add=None if dcf is None else dcf * tc[rx])
            if postf is not None:
                P = P + postf * tc[rx]
            planes.append(P if store is None else store(P))
    return tuple(planes)


# ---------------------------------------------------------------------------
# c2c grid
# ---------------------------------------------------------------------------


def _exact_fraction(plan):
    """(p, q) of the plan's factor as the exact rational H/h == W/w, None
    for integer factors or mismatched axis ratios.  The float factor only
    enters the plan through its integer output dims and band edges, so
    the rational is read from those."""
    uf = Fraction(plan.H, plan.h)
    if uf != Fraction(plan.W, plan.w) or uf.denominator == 1:
        return None
    return uf.numerator, uf.denominator


def c2c_grid_params(plan):
    """(p, q) phase/stride pair of the c2c grid route, or None: integer
    u >= 2 gives (u, 1), a fractional factor its exact p/q.  Needs every
    bin kept on both axes (the zero-pad keep: a partial keep set from
    C-float band edges would leave a non-rank-1 imaginary residue), even
    dims, and splits with q | n1 on both axes."""
    if plan.r2c:
        return None
    if plan.integer_upscale is not None:
        if plan.integer_upscale < 2:
            return None
        p, q = plan.integer_upscale, 1
    else:
        params = _exact_fraction(plan)
        if params is None:
            return None
        p, q = params
    if (
        plan.kept_lo_y + plan.kept_hi_y != plan.h
        or plan.kept_lo_x + plan.kept_hi_x != plan.w
        or plan.h % 2
        or plan.w % 2
        or split_factors(plan.h, multiple_of=q) is None
        or split_factors(plan.w, multiple_of=q) is None
    ):
        return None
    return p, q


def c2c_grid_u(banks: dict):
    """Phase count p of a c2c grid bank set, None when not one."""
    if "cg_ay" not in banks:
        return None
    return banks["cg_ay"].shape[0]


def c2c_grid_staged_banks(plan, dtype: str = "float32") -> dict:
    """Banks of the c2c grid transform (detect: "cg_ay" present):
    cgy{r}_* and cgx{r}_* for phases r = 1..p-1 (the x kernels fold the
    1/255 uint8 normalization in), and the per-phase Nyquist-tone
    amplitudes cg_ay / cg_ax (p,), entry 0 exactly 0 (identity phase)."""
    params = c2c_grid_params(plan)
    if params is None:
        raise ValueError(f"plan has no c2c grid route: {plan}")
    p, q = params
    uf = Fraction(p, q)
    banks = {}
    ay, ax = np.zeros(p), np.zeros(p)
    for r in range(1, p):
        cy, ay[r] = phase_y_kernel(plan.h, plan.kept_lo_y, plan.kept_hi_y, r, uf)
        banks.update(conv_banks(cy, f"cgy{r}_", dtype=dtype, decimate=q))
        cx, ax[r] = phase_y_kernel(plan.w, plan.kept_lo_x, plan.kept_hi_x, r, uf)
        banks.update(conv_banks(cx / 255.0, f"cgx{r}_", dtype=dtype, decimate=q,
                                prefer=x_split_prefer(q, n=plan.w)))
    banks["cg_ay"] = ay.astype(dtype)
    banks["cg_ax"] = ax.astype(dtype)
    return banks


@lru_cache(maxsize=64)
def _signs(n: int, stride: int, dtype, device) -> torch.Tensor:
    """(-1)^(stride*i) for i in [0, n), made once per geometry: a host copy
    inside the frame would wait for the device and stall the stream."""
    return torch.from_numpy((-1.0) ** (stride * np.arange(n))).to(device=device, dtype=dtype)


def c2c_grid_staged(x_raw: torch.Tensor, banks: dict, store=None, load=None):
    """c2c grid transform.  x_raw (..., C, h, w) holds raw pixel values
    0..255 (uint8, or float on the woven float path); returns the p^2
    pre-CAS MAGNITUDE planes row-major (P[0][0], ..., P[p-1][p-1]), each
    (..., C, h/q, w/q), in CAS units.

    store/load: optional pre-CAS storage codec (int16 Q2.14 in half mode):
    the x planes are stored once and the y convolutions decode them inside
    their row-split view; the ry=0 magnitudes use the raw float x planes;
    every returned plane is stored."""
    u = c2c_grid_u(banks)
    mb1 = banks["cgy1_m"]
    qd = mb1.shape[2] // mb1.shape[4]
    acc = banks["cgx1_b1"].dtype
    dev = banks["cgx1_b1"].device
    h, w = x_raw.shape[-2:]
    xf = x_raw.to(acc)
    inv255 = 1.0 / 255.0
    if x_raw.dtype == torch.uint8:
        # signed sums for the rank-1 Nyquist terms, exact in integers: the
        # column and row sums fit int32 (and float32 exactly, < 2^24); the
        # double sum S can pass 2^31, so it is summed in int64 and rounded
        # to float once
        xi = x_raw.to(torch.int32)
        isy = _signs(h, 1, torch.int32, dev)
        isx = _signs(w, 1, torch.int32, dev)
        qcol = (xi * isy[:, None]).sum(dim=-2, keepdim=True).to(acc)  # (..., C, 1, w)
        prow_i = (xi * isx).sum(dim=-1, keepdim=True)  # (..., C, h, 1), int64
        prow = prow_i.to(acc)
        S = (prow_i * isy[:, None].to(torch.int64)).sum(dim=-2, keepdim=True).to(acc)
    else:
        fsy, fsx = _signs(h, 1, acc, dev), _signs(w, 1, acc, dev)
        qcol = (xf * fsy[:, None]).sum(dim=-2, keepdim=True)
        prow = (xf * fsx).sum(dim=-1, keepdim=True)
        S = (prow * fsy[:, None]).sum(dim=-2, keepdim=True)
    # x phase planes, shared by every y phase (rx = 0 is the exact column
    # identity: c2c keeps all w bins, so there is no x-Nyquist correction)
    A = [(xf if qd == 1 else xf[..., ::qd]) * inv255]
    A += [conv_apply_lanes(xf, banks, f"cgx{rx}_") for rx in range(1, u)]
    # rank-1 vectors: V[rx] = C_x (X^T s_y), a one-row x conv; Wv[ry] =
    # C_y (X s_x), a one-column y conv
    V = [(qcol if qd == 1 else qcol[..., ::qd]) * inv255]
    V += [conv_apply_lanes(qcol, banks, f"cgx{rx}_") for rx in range(1, u)]
    Wv = [(prow if qd == 1 else prow[..., ::qd, :]) * inv255]
    Wv += [conv_apply_rows(prow, banks, f"cgy{ry}_") * inv255 for ry in range(1, u)]
    Pcols = A if store is None else [store(a) for a in A]
    sYo = _signs(h // qd, qd, acc, dev)[:, None]
    sXo = _signs(w // qd, qd, acc, dev)
    return c2c_planes_from_pencils(Pcols, V, Wv, S * inv255, banks, sYo, sXo, qd,
                                   store=store, raws=A, load=load)


def c2c_planes_from_pencils(Pcols, V, Wv, Sn, banks, sYo, sXo, qd, store=None, raws=None,
                            load=None):
    """Assemble the p^2 c2c magnitude planes from the x-phase planes and
    the rank-1 Nyquist pieces.

    Pcols: p x-phase planes (..., C, h, w/q), stored when `load` is given
    V:     p rank-1 column vectors (..., C, 1, w/q)
    Wv:    p rank-1 row vectors (..., C, h/q, 1)
    Sn:    the signed double sum s_y^T X s_x / 255, (..., C, 1, 1)
    raws:  the p float x-phase planes before the codec, for the ry=0
           magnitudes

    The ry >= 1 magnitudes are computed inside conv_apply_rows' epilogue on
    the (..., n2, nd, L) view, where the row-broadcast terms take the
    (n2, nd, 1) shape."""
    u = c2c_grid_u(banks)
    enc = (lambda t: t) if store is None else store
    planes = []
    for ry in range(u):
        ayv = banks["cg_ay"][ry]
        if ry:
            n2 = banks[f"cgy{ry}_b1"].shape[0]
            nd = banks[f"cgy{ry}_m"].shape[4]
            sY4 = sYo.reshape(n2, nd, 1)
        for rx in range(u):
            axv = banks["cg_ax"][rx]
            if ry == 0:
                src = raws[rx] if raws is not None else Pcols[rx]
                re = src if qd == 1 else src[..., ::qd, :]
                if rx == 0:
                    P = torch.abs(re)
                else:
                    im = axv * sXo * Wv[0]
                    P = torch.sqrt(re * re + im * im)
                planes.append(enc(P))
                continue

            # a_0 == 0 exactly: the identity phases skip the rank-1 terms
            def _mag(y4, ry=ry, rx=rx, ayv=ayv, axv=axv, sY4=sY4):
                re4 = y4
                if rx:
                    re4 = re4 - (ayv * axv) * Sn[..., None] * (sY4 * sXo)
                W4 = Wv[ry].reshape(Wv[ry].shape[:-2] + sY4.shape)
                if rx:
                    im4 = axv * sXo * W4 + ayv * sY4 * V[rx][..., None, :, :]
                else:
                    im4 = ayv * sY4 * V[rx][..., None, :, :]
                return enc(torch.sqrt(re4 * re4 + im4 * im4))

            planes.append(conv_apply_rows(Pcols[rx], banks, f"cgy{ry}_", load=load,
                                          epilogue=_mag))
    return tuple(planes)
