"""Pencil-decomposed upscale: one frame sharded over the ranks of a
torch.distributed group, the "sp" mode (counterpart of
vkresample_tpu/parallel/distributed.py).

Rows of the frame live on different ranks; each axis pass runs where its
axis is whole, and one all-to-all re-pencils between the x and the y
passes.  This serves frames too large for one card.  Start the ranks with
parallel/launch.py::spawn (or any torch.distributed launcher) and call a
builder on every rank:

  build_sp_upscale          r2c integer u: torch.fft pencils, rows in and
                            rows out, CAS on K6 with halo rows by pointer
  build_sp_upscale_dense    r2c integer u >= 2: the row-split GEMM banks
  build_sp_upscale_staged   r2c u = 2: the staged quad's convolutions
  build_sp_upscale_grid     r2c integer u >= 2 or p/q: the staged grid
  build_sp_upscale_c2c_grid c2c integer u >= 2 or p/q: the c2c staged grid

The last four take rows in and give columns out, and run K3 on the woven
block with one halo column from each neighbour, read by pointer.  Each
builder returns fn(block): block is this rank's (h/S, w, C) uint8 rows
(shard_rows), and fn gives its (H/S, W, C) rows or (H, W/S, C) columns,
the JAX package's in_specs and out_specs (gather_blocks joins them).
Banks are built once per rank and device (through core/bankcache.py) and
uploaded once.

Each body does one all-to-all, one halo exchange (an all_gather of every
rank's two edge rows or columns) and at most a small all_reduce (the
rank-1 y-Nyquist correction, contracted over the sharded rows) or
all_gather (the c2c row sums).  all_to_all and all_gather move raw bytes,
so int16 Q2.14 planes cross as they are (neither gloo nor NCCL has an
int16 type).  Departures from the JAX package: the rows form runs cuFFT
pencils, where JAX runs its phase-decomposed FFTs (fft/rfft2.py, a TPU
stand-in for an FFT); the CAS is the port's kernels, where JAX runs plain
jnp; -p 2 keeps its Q2.14 storage on the GEMM and staged forms, as the
single-card routes do.  K6 takes float32 only, so the rows form runs the
pre-CAS image in float32 at -p 0 and -p 2; -p 1 (float64) runs every form
in float64 with the float64 banded CAS (ops/cas.py) on the haloed block,
no kernel, as the single-card -p 1.  The int16 and float32 shard CAS is
one kernel launch that reads the halos where they lie: no copy of the
shard.

Every call runs inside core/config.py::fp32_matmul().  A rank's device is
cuda:{rank % device_count} unless the builder is given one; without a card
and without device="cpu" the builders raise (core/config.py::
resolve_device).  NCCL needs one card per rank; gloo takes CPU tensors,
and CUDA tensors through host memory.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.bankcache import get_or_build
from ..core.config import Precision, fp32_matmul, resolve_device
from ..core.plan import UpscalePlan
from ..fft import dense, staged
from ..fft.staged import _signs, _xnyq_colsum
from ..ops import cas as cas_ops
from ..ops.cas_cuda import cas_quantize_blocked_halo, cas_quantize_cols_halo
from ..ops.weave import weave_grid

# ---------------------------------------------------------------------------
# collectives, with jax.lax's semantics
# ---------------------------------------------------------------------------

_clock = None  # [seconds] while collective_seconds() is active


@contextlib.contextmanager
def collective_seconds():
    """Time this module's collectives inside the block: each one
    synchronizes the device before and after and adds its host seconds to
    the yielded list's only entry.  Off by default (no synchronization)."""
    global _clock
    saved, _clock = _clock, [0.0]
    try:
        yield _clock
    finally:
        _clock = saved


def _timed(collective):
    @functools.wraps(collective)
    def run(x, *args):
        if _clock is None:
            return collective(x, *args)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = collective(x, *args)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        _clock[0] += time.perf_counter() - t0
        return out

    return run


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a contiguous uint8 tensor (last axis times the element
    size), for the collectives that only move data."""
    return x.contiguous().view(torch.uint8)


@_timed
def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True): x is cut
    into S pieces along split_axis, piece j goes to rank j, and the pieces
    received are joined along concat_axis in rank order."""
    S = dist.get_world_size(group)
    split_axis %= x.dim()
    xs = x.movedim(split_axis, 0)
    n = xs.shape[0]
    if n % S:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"into {S}")
    send = _bytes(xs.reshape((S, n // S) + xs.shape[1:]))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    parts = recv.view(x.dtype).movedim(1, split_axis + 1)  # (S, x's shape, axis cut)
    return torch.cat(parts.unbind(0), dim=concat_axis)


@_timed
def _all_gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """jax.lax.all_gather(x, axis=axis, tiled=True): every rank's x joined
    along axis in rank order."""
    send = _bytes(x)
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat([p.view(x.dtype) for p in parts], dim=axis)


@_timed
def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """jax.lax.psum: the sum of x over the ranks."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _halos(x: torch.Tensor, axis: int, group):
    """(before, after) of this rank's block x along axis (-2: rows, -1:
    columns): the previous rank's last row or column and the next rank's
    first, each with size 1 on axis, clamped to x's own edge at the first
    and last rank (CAS clamp-to-edge; distributed.py:46, :222).  One
    all_gather of every rank's two edges."""
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    first, last = x.narrow(axis, 0, 1), x.narrow(axis, x.shape[axis] - 1, 1)
    edges = _all_gather(torch.stack([first, last])[None], 0, group)  # (S, 2, ...)
    before = edges[rank - 1, 1] if rank > 0 else first
    after = edges[rank + 1, 0] if rank < S - 1 else last
    return before, after


def _halo_rows(x: torch.Tensor, group):
    return _halos(x, -2, group)


def _halo_cols(x: torch.Tensor, group):
    return _halos(x, -1, group)


# ---------------------------------------------------------------------------
# the CAS of a shard
# ---------------------------------------------------------------------------


def _cas_rows(v: torch.Tensor, sharpen: float, group) -> torch.Tensor:
    """CAS + quantize of this rank's rows v (C, rows, W): K6 on the shard
    as one block, the neighbours' edge rows its halos; float64 runs the
    banded CAS on the block padded with them."""
    above, below = _halo_rows(v, group)
    if v.dtype == torch.float64:
        vpad = torch.cat([above, v, below], dim=-2)
        return cas_ops.cas_quantize_banded(vpad, sharpen)[..., 1:-1, :].contiguous()
    return cas_quantize_blocked_halo(v, above.contiguous(), below.contiguous(), sharpen)


def _cas_cols(v: torch.Tensor, sharpen: float, group) -> torch.Tensor:
    """CAS + quantize of this rank's columns v (C, H, cols): K3's
    column-halo entry (int16 or float32) with the neighbours' edge columns
    as its halos; float64 runs the banded CAS on [left | v | right] and
    crops the two halo columns.  Every rank holds all H rows, so rows need
    no halo."""
    left, right = _halo_cols(v, group)
    if v.dtype == torch.float64:
        vpad = torch.cat([left, v, right], dim=-1)
        return cas_ops.cas_quantize_banded(vpad, sharpen)[..., 1:-1].contiguous()
    return cas_quantize_cols_halo(v, left.contiguous(), right.contiguous(), sharpen)


def _codec(plan: UpscalePlan):
    """(store, load) of the pre-CAS storage codec: int16 Q2.14 at -p 2."""
    if plan.precision is Precision.HALF:
        return cas_ops.to_i16_storage, cas_ops.from_i16_storage
    return None, None


def _shard(n: int, S: int, rank: int) -> slice:
    return slice(rank * (n // S), (rank + 1) * (n // S))


# ---------------------------------------------------------------------------
# the five bodies: x_raw (C, h/S, w) uint8 -> (C, H/S, W) or (C, H, W/S) uint8
# ---------------------------------------------------------------------------


def _rows_body(x_raw, plan: UpscalePlan, banks, group, S: int, rank: int):
    """The reference tier's transform (pipeline/upscale.py::_precas_xla)
    in pencils: rfft over x on the rows, all-to-all to columns, fft over y,
    the kept rows moved to the big spectrum, ifft over y, all-to-all back
    to rows, the kept columns moved, irfft over x, then K6 with halo rows
    (the shard one block).
    The half spectrum's w/2+1 columns are padded with zeros to a multiple
    of S so they split evenly."""
    h, w, H, W = plan.h, plan.w, plan.H, plan.W
    kpad = -(-(w // 2 + 1) // S) * S
    x = cas_ops.normalize_u8(x_raw, plan.precision.compute_dtype)
    F = torch.fft.rfft(x, dim=-1)  # (C, h/S, w/2+1)
    F = torch.cat([F, F.new_zeros(F.shape[:-1] + (kpad - F.shape[-1],))], dim=-1)
    F = torch.fft.fft(_all_to_all(F, 2, 1, group), dim=-2)  # (C, h, kpad/S)
    # the y part of assemble_big_spectrum (ops/spectrum.py): separable
    G = F.new_zeros(F.shape[:-2] + (H, F.shape[-1]))
    klo, khi = plan.kept_lo_y, plan.kept_hi_y
    G[..., :klo, :] = F[..., :klo, :]
    if khi:
        G[..., H - khi:, :] = F[..., h - khi:, :]
    g = _all_to_all(torch.fft.ifft(G, dim=-2), 1, 2, group)[..., :w // 2 + 1]  # (C, H/S, .)
    B = g.new_zeros(g.shape[:-1] + (W // 2 + 1,))
    kx, kxh, xr = plan.kept_lo_x, plan.kept_hi_x, plan.x_right
    B[..., :kx] = g[..., :kx]
    if kxh:
        B[..., xr:xr + kxh] = g[..., xr:xr + kxh]
    # the C2R drops the imaginary parts of the DC and Nyquist columns
    # (pipeline/upscale.py::_irfft2)
    B[..., 0].imag.zero_()
    if W % 2 == 0:
        B[..., W // 2].imag.zero_()
    u2 = float(np.float32(float(np.float32(plan.upscale)) ** 2))
    return _cas_rows(u2 * torch.fft.irfft(B, n=W, dim=-1), plan.sharpen, group)


def _dense_body(x_raw, plan: UpscalePlan, banks, group, S: int, rank: int):
    """dense.r2c_rows in pencils: the x GEMM on the rows gives U (C, h/S,
    W), stored as Q2.14 at -p 2; one all-to-all to columns; the y GEMM
    over all h rows with the y-Nyquist correction (its row contraction
    summed over the ranks); the row weave; K3 with halo columns."""
    h, W, u = plan.h, plan.W, plan.integer_upscale
    store, load = _codec(plan)
    xf = x_raw.to(banks["alpha"].dtype)
    U = torch.matmul(xf, banks["alpha"])
    if store is not None:
        U = store(U)
    U = _all_to_all(U, 2, 1, group)  # (C, h, W/S)
    O = torch.matmul(banks["Ymat_ns"][:h].transpose(0, 1), U if load is None else load(U))
    if "Y1n" in banks:
        tcorr = _psum(torch.matmul(banks["Y1n"][_shard(h, S, rank)].transpose(0, 1), xf),
                      group)  # (C, r, w)
        t2 = torch.matmul(tcorr, banks["beta"][:, _shard(W, S, rank)])
        O = O + torch.matmul(banks["Ymat_ns"][h:].transpose(0, 1), t2)
    if store is not None:
        O = store(O)
    return _cas_cols(dense.weave_rows(U, O, u), plan.sharpen, group)


def _staged_body(x_raw, plan: UpscalePlan, banks, group, S: int, rank: int):
    """staged.r2c_quad_staged in pencils: the x conv and the sample plane
    on the rows, both planes in ONE all-to-all, the y convs on the columns
    (the rank-1 y-Nyquist row summed over the ranks), the quad weave and
    K3 with halo columns."""
    h, w = plan.h, plan.w
    store, load = _codec(plan)
    acc = banks["stx_b1"].dtype
    xf = x_raw.to(acc)
    P01 = staged.conv_apply_lanes(xf, banks, "stx_")
    q = _xnyq_colsum(x_raw, xf)
    P00 = xf * (1.0 / 255.0) - (_signs(w, 1, acc, xf.device) * q) * (1.0 / (255.0 * w))
    cols = _shard(w, S, rank)
    dc_e = dc_o = post = None
    if "st_y1n" in banks:
        tcorr = _psum(torch.matmul(banks["st_y1n"][_shard(h, S, rank)].transpose(0, 1), xf),
                      group)  # (C, 1, w)
        t2o = staged.conv_apply_lanes(tcorr, banks, "stbo_")[..., cols]
        t2e = staged.conv_apply_lanes(tcorr, banks, "stbe_")[..., cols]
        n1 = banks["sty_m"].shape[2]
        dcf, post = staged.ynyq_dc_or_post(banks["st_yc"], n1, n1, 1, h)
        if dcf is not None:
            dc_e, dc_o = dcf * t2e, dcf * t2o
    Pst = torch.stack([P00, P01] if store is None else [store(P00), store(P01)])
    P00c, P01c = _all_to_all(Pst, 3, 2, group).unbind(0)  # (C, h, w/S) each
    P10 = staged.conv_apply_rows(P00c, banks, "sty_", load=load, dc_add=dc_e)
    P11 = staged.conv_apply_rows(P01c, banks, "sty_", load=load, dc_add=dc_o)
    if post is not None:
        P10 = P10 + post * t2e
        P11 = P11 + post * t2o
    if store is not None:
        P10, P11 = store(P10), store(P11)
    return _cas_cols(weave_grid((P00c, P01c, P10, P11), 2), plan.sharpen, group)


def _grid_body(x_raw, plan: UpscalePlan, banks, group, S: int, rank: int):
    """staged.r2c_grid_staged in pencils: the p x-phase planes on the rows
    in ONE all-to-all, the p(p-1) y convs on the columns (the rank-1
    y-Nyquist row summed over the ranks), the grid weave and K3 with halo
    columns."""
    h, w = plan.h, plan.w
    store, load = _codec(plan)
    u = staged.grid_u(banks)
    qd = banks["sgy1_m"].shape[2] // banks["sgy1_m"].shape[4]
    acc = banks["sgx1_b1"].dtype
    xf = x_raw.to(acc)
    q = _xnyq_colsum(x_raw, xf)
    xs = xf if qd == 1 else xf[..., ::qd]
    P0 = [xs * (1.0 / 255.0) - (_signs(w // qd, qd, acc, xf.device) * q) * (1.0 / (255.0 * w))]
    P0 += [staged.conv_apply_lanes(xf, banks, f"sgx{rx}_") for rx in range(1, u)]
    cols = _shard(w // qd, S, rank)
    tc = None
    if "sg_y1n" in banks:
        tcorr = _psum(torch.matmul(banks["sg_y1n"][_shard(h, S, rank)].transpose(0, 1), xf),
                      group)  # (C, 1, w)
        tc = [staged.conv_apply_lanes(tcorr, banks, f"sgb{rx}_")[..., cols] for rx in range(u)]
    Pst = _all_to_all(torch.stack(P0 if store is None else [store(p) for p in P0]), 3, 2,
                      group).unbind(0)  # p x (C, h, w/(q S))
    planes = list(Pst) if qd == 1 else [p[..., ::qd, :].contiguous() for p in Pst]
    for ry in range(1, u):
        mb = banks[f"sgy{ry}_m"]
        dcf = postf = None
        if tc is not None:
            dcf, postf = staged.ynyq_dc_or_post(banks[f"sg_yc{ry}"], mb.shape[2], mb.shape[4],
                                                qd, h // qd)
        for rx in range(u):
            P = staged.conv_apply_rows(Pst[rx], banks, f"sgy{ry}_", load=load,
                                       dc_add=None if dcf is None else dcf * tc[rx])
            if postf is not None:
                P = P + postf * tc[rx]
            planes.append(P if store is None else store(P))
    return _cas_cols(weave_grid(planes, u), plan.sharpen, group)


def _c2c_grid_body(x_raw, plan: UpscalePlan, banks, group, S: int, rank: int):
    """staged.c2c_grid_staged in pencils: the signed column sums summed
    over the ranks, the signed row sums gathered from them, the p x-phase
    planes on the rows in ONE all-to-all (float, stored as Q2.14 after it
    at -p 2, so that the ry = 0 magnitudes read the float planes as on one
    card), the magnitudes on the columns (staged.c2c_planes_from_pencils),
    the grid weave and K3 with halo columns."""
    h, w = plan.h, plan.w
    store, load = _codec(plan)
    u = staged.c2c_grid_u(banks)
    qd = banks["cgy1_m"].shape[2] // banks["cgy1_m"].shape[4]
    acc = banks["cgx1_b1"].dtype
    dev = x_raw.device
    xf = x_raw.to(acc)
    inv255 = 1.0 / 255.0
    # signed sums, exact in integers (staged.c2c_grid_staged)
    xi = x_raw.to(torch.int32)
    isy = _signs(h, 1, torch.int32, dev)
    qcol = _psum((xi * isy[_shard(h, S, rank), None]).sum(dim=-2, keepdim=True),
                 group).to(acc)  # (C, 1, w)
    prow_i = _all_gather((xi * _signs(w, 1, torch.int32, dev)).sum(dim=-1, keepdim=True),
                         -2, group)  # (C, h, 1) int64
    prow = prow_i.to(acc)
    Sn = (prow_i * isy[:, None].to(torch.int64)).sum(dim=-2, keepdim=True).to(acc) * inv255
    A = [(xf if qd == 1 else xf[..., ::qd]) * inv255]
    A += [staged.conv_apply_lanes(xf, banks, f"cgx{rx}_") for rx in range(1, u)]
    cols = _shard(w // qd, S, rank)
    V = [(qcol if qd == 1 else qcol[..., ::qd]) * inv255]
    V += [staged.conv_apply_lanes(qcol, banks, f"cgx{rx}_") for rx in range(1, u)]
    V = [v[..., cols] for v in V]
    Wv = [(prow if qd == 1 else prow[..., ::qd, :]) * inv255]
    Wv += [staged.conv_apply_rows(prow, banks, f"cgy{ry}_") * inv255 for ry in range(1, u)]
    raws = list(_all_to_all(torch.stack(A), 3, 2, group).unbind(0))  # p x (C, h, w/(q S))
    sYo = _signs(h // qd, qd, acc, dev)[:, None]
    sXo = _signs(w // qd, qd, acc, dev)[cols]
    planes = staged.c2c_planes_from_pencils(
        raws if store is None else [store(a) for a in raws], V, Wv, Sn, banks, sYo, sXo, qd,
        store=store, raws=raws, load=load)
    return _cas_cols(weave_grid(planes, u), plan.sharpen, group)


# ---------------------------------------------------------------------------
# checks (JAX's messages) and banks
# ---------------------------------------------------------------------------


def check_sp(kind: str, plan: UpscalePlan, shards: int) -> None:
    """Raise the JAX package's ValueError when the pencil form `kind`
    ("rows", "dense", "staged", "grid", "c2c_grid") cannot run `plan` over
    `shards` ranks.  Each builder runs it first; it needs no process
    group."""
    S = shards
    if kind == "rows":
        if plan.integer_upscale is None:
            raise ValueError("distributed pipeline requires an integer upscale factor")
        if not plan.r2c:
            raise ValueError("distributed pipeline requires an r2c plan")
        if plan.h % (2 * S):
            raise ValueError(f"h={plan.h} must divide into 2*{S} row-paired shards")
    elif kind == "dense":
        if not dense.r2c_rows_supported(plan):
            raise ValueError("dense pencil pipeline requires an integer upscale factor >= 2 "
                             "(row-split fast path)")
        if plan.h % S or plan.W % S:
            raise ValueError(f"h={plan.h} and W={plan.W} must divide into {S} shards")
    elif kind == "staged":
        if not staged.staged_supported(plan):
            raise ValueError("staged pencil pipeline requires a u=2 plan with usable "
                             "Cooley-Tukey splits on both axes")
        if plan.h % S or plan.w % S:
            raise ValueError(f"h={plan.h} and w={plan.w} must divide into {S} shards")
    elif kind in ("grid", "c2c_grid"):
        params = (staged.grid_params if kind == "grid" else staged.c2c_grid_params)(plan)
        if params is None:
            raise ValueError(
                "grid pencil pipeline requires a grid-staged-executable r2c plan (integer "
                "u >= 2 or exact rational p/q with q | dims and matching band keep-set, "
                "usable splits)" if kind == "grid" else
                "c2c grid pencil pipeline requires a c2c-grid-staged-executable plan "
                "(integer u >= 2 or exact rational p/q with q | dims and matching band "
                "keep-set)")
        qd = params[1]
        if plan.h % S or (plan.w // qd) % S:
            raise ValueError(f"h={plan.h} and w/q={plan.w // qd} must divide into {S} shards")
    else:
        raise ValueError(f"unknown pencil form {kind!r}")


# form -> (bank builder, its cache tag at -p 0 and -p 2, at -p 1), None: no banks
_BANKS = {
    "rows": None,
    "dense": (dense.r2c_rows_banks, "rows", "rows"),
    "staged": (staged.r2c_quad_staged_banks, "staged", "staged64"),
    "grid": (staged.r2c_grid_staged_banks, "grid", "grid64"),
    "c2c_grid": (staged.c2c_grid_staged_banks, "c2cgrid", "c2cgrid64"),
}
_BODIES = {"rows": _rows_body, "dense": _dense_body, "staged": _staged_body,
           "grid": _grid_body, "c2c_grid": _c2c_grid_body}
# the axis of the frame each form's output blocks split: rows, or columns
OUTPUT_AXIS = {"rows": 0, "dense": 1, "staged": 1, "grid": 1, "c2c_grid": 1}


def _device_banks(kind: str, plan: UpscalePlan, device: torch.device):
    """The form's numpy banks (float32, float64 at -p 1; from the disk
    bank cache) uploaded to `device`; the quad x bank alpha_odd, which no
    pencil form reads, stays behind."""
    if _BANKS[kind] is None:
        return None
    build, tag, tag64 = _BANKS[kind]
    double = plan.precision is Precision.DOUBLE
    dtype = "float64" if double else "float32"
    banks = get_or_build(tag64 if double else tag, plan, dtype,
                         functools.partial(build, plan, dtype))
    return {k: torch.from_numpy(v).to(device) for k, v in banks.items() if k != "alpha_odd"}


@functools.lru_cache(maxsize=16)
def _build(kind: str, plan: UpscalePlan, group, device: torch.device) -> Callable:
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    check_sp(kind, plan, S)
    banks = _device_banks(kind, plan, device)
    body = _BODIES[kind]
    rows = plan.h // S

    def fn(block):
        with fp32_matmul():
            blk = torch.as_tensor(block)
            if blk.dim() == 2:
                blk = blk[:, :, None]
            if blk.dtype != torch.uint8 or blk.dim() != 3 or tuple(blk.shape[:2]) != (rows, plan.w):
                raise ValueError(f"rank {rank} of {S} takes a ({rows}, {plan.w}, C) uint8 "
                                 f"block, got {tuple(blk.shape)} {blk.dtype}")
            x_raw = blk.to(device).movedim(-1, 0).contiguous()  # (C, h/S, w)
            return body(x_raw, plan, banks, group, S, rank).movedim(0, -1).contiguous()

    return fn


def _rank_device(device) -> torch.device:
    """The given device, else cuda:{rank % device_count}; RuntimeError
    without a card (resolve_device)."""
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return resolve_device(device)


def _builder(kind: str, plan: UpscalePlan, group, device) -> Callable:
    return _build(kind, plan, dist.group.WORLD if group is None else group,
                  _rank_device(device))


def build_sp_upscale(plan: UpscalePlan, group=None, device=None) -> Callable:
    """One frame (h, w, C) uint8, rows sharded over the ranks of `group`
    (default: the whole world) -> (H, W, C) uint8, rows sharded: fn(block)
    takes this rank's (h/S, w, C) rows and gives its (H/S, W, C) rows.
    Integer u and h % (2*S) == 0, as in the JAX package.  device: this
    rank's device (default cuda:{rank % device_count}; "cpu" runs the
    kernels' plain versions)."""
    return _builder("rows", plan, group, device)


def build_sp_upscale_dense(plan: UpscalePlan, group=None, device=None) -> Callable:
    """Row-split GEMM pencil form, integer u >= 2: this rank's (h/S, w, C)
    rows in, its (H, W/S, C) columns out.  h % S == 0 and W % S == 0."""
    return _builder("dense", plan, group, device)


def build_sp_upscale_staged(plan: UpscalePlan, group=None, device=None) -> Callable:
    """Staged quad pencil form (u = 2, banks O(n*n1) at any size): this
    rank's (h/S, w, C) rows in, its (H, W/S, C) columns out.  h % S == 0
    and w % S == 0."""
    return _builder("staged", plan, group, device)


def build_sp_upscale_grid(plan: UpscalePlan, group=None, device=None) -> Callable:
    """Staged grid pencil form (r2c, integer u >= 2 or a fraction p/q):
    this rank's (h/S, w, C) rows in, its (H, W/S, C) columns out.  h % S
    == 0 and (w/q) % S == 0."""
    return _builder("grid", plan, group, device)


def build_sp_upscale_c2c_grid(plan: UpscalePlan, group=None, device=None) -> Callable:
    """c2c staged grid pencil form (integer u >= 2 or p/q): this rank's
    (h/S, w, C) rows in, its (H, W/S, C) columns out.  h % S == 0 and
    (w/q) % S == 0."""
    return _builder("c2c_grid", plan, group, device)


BUILDERS = {"rows": build_sp_upscale, "dense": build_sp_upscale_dense,
            "staged": build_sp_upscale_staged, "grid": build_sp_upscale_grid,
            "c2c_grid": build_sp_upscale_c2c_grid}


def shard_rows(img, rank: int, shards: int):
    """Rank `rank`'s rows of an (h, w, C) frame (numpy or tensor) cut into
    `shards` equal row blocks."""
    h = img.shape[0]
    if h % shards:
        raise ValueError(f"{h} rows do not split into {shards} shards")
    r = h // shards
    return img[rank * r:(rank + 1) * r]


def gather_blocks(blocks, axis: int):
    """The frame from every rank's block in rank order: rows (axis 0) or
    columns (axis 1); numpy arrays or tensors."""
    if isinstance(blocks[0], np.ndarray):
        return np.concatenate(list(blocks), axis=axis)
    return torch.cat(list(blocks), dim=axis)
