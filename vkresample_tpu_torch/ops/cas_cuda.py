"""Fused CAS + quantize kernels: their wrappers and plain PyTorch versions.

Counterparts of vkresample_tpu/ops/cas_pallas.py:

  K1 cas_parity4_planes_u2  quad-parity CAS (u=2 quad route)   csrc/cas_grid.cu
                                                               (K4's U=2 instance)
  K2 cas_parity_planes_u2   rows-parity CAS (u=2 rows route)   csrc/cas_rows.cu
                                                               (K5's kernel at u=2)
  K3 cas_quantize           woven CAS (cas_quantize_pallas)    csrc/cas_rows.cu
                                                               (K5's kernel at u=1)
     cas_quantize_cols_halo K3 on a column block, its outer    csrc/cas_rows.cu
                            columns from two halo columns      (the same, halo
                            (the sp column forms' shard CAS,   columns by pointer)
                            parallel/distributed.py)
  K4 cas_parity_grid_planes grid-parity CAS (u x u planes)     csrc/cas_grid.cu
  K5 cas_quantize_rows_u    fused row weave + woven CAS        csrc/cas_rows.cu
                            (integer u >= 3 rows route)
  K6 cas_quantize_blocked   woven CAS over row blocks fed      csrc/cas_rows.cu
                            per-block halo rows (f32)          (K5's kernel at u=1,
                            (cas_quantize_blocked_halo: the    block-local bands,
                            row-sharded sp mode's CAS,         halo rows by pointer,
                            parallel/distributed.py)           sqrt/divide blend)
  K7 cas_quantize_mono      woven CAS, one persistent launch   csrc/cas_mono.cu
                            on a warp-specialized streaming    (stream_pipeline.cuh)
                            pipeline (f32)

All seven compute the same thing: the 3x3 clamp-to-edge CAS + quantize of
a woven pre-CAS image, int16 Q2.14 or float32, to uint8.  K1, K2 and K4
take that image as parity planes and return uint8 planes of the same
layout, K5 as the row-split pair (U, O) and returns the woven image, so
the woven pre-CAS image never exists on the device.  K6 and K7 take the
woven image in float32 only, as their JAX kernels do.  K6 runs on the
row-sharded sp mode, each rank's rows as one block with its neighbours'
edge rows as the halos, and K3's column-halo entry on the column-sharded
forms, each rank's columns with its neighbours' edge columns; K7 is on no
route (in the JAX package only A/B scripts call it).  One plain version,
``cas_quantize_reference``, holds the arithmetic; the other kernels' plain
versions weave their inputs, call it and split the result.  K6 alone
evaluates the blend as sqrt(num/den) with a divide (its JAX kernel's form,
1 LSB from the others' rsqrt form on rare pixels), and its plain version
``cas_quantize_blocked_reference`` takes the kernel's own halo-row inputs.
See each kernel source's header for its design.  The fused y-GEMM + CAS
kernels K8 and K9 are in ops/ycas_cuda.py.

Each wrapper runs its kernel on a CUDA tensor (on the current stream; a
launch error raises) and its plain version on a CPU tensor, and counts its
kernel launches in ``.launches`` (K6's, from its three wrappers, in
``cas_quantize_blocked.launches``).  K1, K2 and K3 also record in
``.staging`` the staging form (``staging_form``) of their last launch, and
K7 (and K10b, ops/quantize_cuda.py) the copy form (``stream_form``) of its.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..fft.dense import weave_rows
from .cas import from_i16_storage
from .weave import weave_grid

_DTYPES = (torch.int16, torch.float32)


def _check(what: str, tensors, shapes=None) -> None:
    """Raise unless the planes are int16 or float32 of one dtype on one
    device, contiguous, and of the first plane's shape (or of `shapes`)."""
    t0 = tensors[0]
    if t0.dtype not in _DTYPES:
        raise TypeError(f"{what} takes int16 or float32 planes, got {t0.dtype}")
    if t0.dim() < 2:
        raise ValueError(f"{what} planes need (..., rows, cols), got {tuple(t0.shape)}")
    shapes = [tuple(s) for s in shapes] if shapes else [tuple(t0.shape)] * len(tensors)
    for t, shape in zip(tensors[1:], shapes[1:]):
        if t.device != t0.device or t.dtype != t0.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{what} planes must share device, dtype and shape (want {shapes}): "
                f"{[(str(q.device), q.dtype, tuple(q.shape)) for q in tensors]}"
            )
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} planes must be contiguous")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {t0.device}")


def _launch(entry: str, device, *args) -> None:
    """Call the kernel library's C entry point on the current stream of
    `device`; raise on a non-zero cudaError_t."""
    from .._build import load_kernels

    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")


def staging_form(row_bytes: int, ptrs) -> str:
    """How the kernels of csrc/cas_grid.cu and csrc/cas_rows.cu (K1, K2, K3,
    K4, K5) copy their inputs into shared memory: "16-byte" (cp.async chunks)
    where a row of row_bytes is a whole number of 16-byte chunks and every
    input address in ptrs is on a 16-byte boundary, else "per element"."""
    aligned = row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return "16-byte" if aligned else "per element"


def stream_form(W: int, v_ptr: int, out_ptr: int) -> str:
    """How csrc/stream_pipeline.cuh (K7, K10b) copies rows into its rings:
    "bulk" (one cp.async.bulk per row, 32-bit stores out) where W % 4 == 0,
    v starts on a 16-byte boundary and out on a 4-byte one, else "per
    element" (a 4-byte cp.async per element, byte stores out)."""
    aligned = W % 4 == 0 and v_ptr % 16 == 0 and out_ptr % 4 == 0
    return "bulk" if aligned else "per element"


def _blend_u8(c, nsum, minlen, maxlen, sharpen: float, divide: bool = False) -> torch.Tensor:
    """_cas_blend (cas_pallas.py:637-656): the rsqrt form with the 1e-30
    floor, or with `divide` _cas_blk_kernel's sqrt(num/den) form
    (cas_pallas.py:2416-2420); then x255, clamp, truncate."""
    a, b = minlen, 1.0 - minlen
    cq, d = 1.0 - maxlen, maxlen
    pred = a * d < cq * b
    num = torch.where(pred, a, cq)
    den = torch.where(pred, b, d)
    if divide:
        sc = -sharpen * torch.sqrt(torch.clamp(num / den, min=0.0))
    else:
        sc = (-sharpen * num) * torch.rsqrt(torch.clamp(num * den, min=1e-30))
    out = (c + sc * nsum) / (1.0 + 4.0 * sc)
    return torch.clamp(out * 255.0, 0.0, 255.0).to(torch.int32).to(torch.uint8)


def _stencil_u8(c, n, s, sharpen: float, divide: bool = False) -> torch.Tensor:
    """CAS + quantize of the L rows c (N, H, W) whose north and south
    neighbour rows are n and s (same shape, already clamped or taken from
    halo rows by the caller); columns clamp to the edge."""
    pc, pn, ps = (F.pad(t, (1, 1), mode="replicate") for t in (c, n, s))
    w, e = pc[..., :-2], pc[..., 2:]
    nw, ne = pn[..., :-2], pn[..., 2:]
    sw, se = ps[..., :-2], ps[..., 2:]
    mn, mx = torch.minimum, torch.maximum
    min_cross = mn(mn(n, s), mn(c, mn(w, e)))
    max_cross = mx(mx(n, s), mx(c, mx(w, e)))
    min_all = mn(min_cross, mn(mn(nw, ne), mn(sw, se)))
    max_all = mx(max_cross, mx(mx(nw, ne), mx(sw, se)))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)
    return _blend_u8(c, (n + s) + (w + e), minlen, maxlen, sharpen, divide)


def _clip_len(f: torch.Tensor) -> torch.Tensor:
    return torch.clamp(f.abs(), max=1.0)


# ---------------------------------------------------------------------------
# K3: woven CAS
# ---------------------------------------------------------------------------


def cas_quantize_reference(v: torch.Tensor, sharpen: float) -> torch.Tensor:
    """Plain PyTorch version of the woven CAS kernel, on any device:
    (..., H, W) int16 Q2.14 or float32 pre-CAS image (u^2 pre-scale folded
    in) -> (..., H, W) uint8.  L = min(|v|, 1), edge-clamped 3x3 CAS with
    the kernel's rsqrt blend (cas_pallas.py:134-202), quantize."""
    _check("woven CAS", (v,))
    H, W = v.shape[-2:]
    f = from_i16_storage(v) if v.dtype == torch.int16 else v
    L = _clip_len(f.reshape(-1, H, W))
    n = torch.cat([L[:, :1], L[:, :-1]], dim=1)
    s = torch.cat([L[:, 1:], L[:, -1:]], dim=1)
    return _stencil_u8(L, n, s, sharpen).reshape(v.shape)


def cas_quantize(v: torch.Tensor, sharpen: float) -> torch.Tensor:
    """Woven CAS + quantize: (..., H, W) int16 Q2.14 or float32 -> uint8
    of the same shape.  CUDA tensors go through csrc/cas_rows.cu's kernel
    at u = 1 (identical on every pixel to the plain version), CPU tensors
    take the plain version."""
    _check("woven CAS", (v,))
    if v.device.type == "cpu":
        return cas_quantize_reference(v, sharpen)
    H, W = v.shape[-2:]
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    if v.numel() == 0:
        return out
    ptr = v.data_ptr()
    _launch("vkr_cas_woven", v.device, ptr, out.data_ptr(),
            v.numel() // (H * W), H, W, int(v.dtype == torch.int16), float(sharpen))
    cas_quantize.launches += 1
    cas_quantize.staging = staging_form(W * v.element_size(), (ptr,))
    return out


cas_quantize.launches = 0
cas_quantize.staging = None


def _check_cols_halo(v, left, right) -> None:
    _check("woven CAS", (v,))
    col = v.shape[:-1] + (1,)
    _check("woven CAS halo", (v, left, right), (v.shape, col, col))


def cas_quantize_cols_halo_reference(v, left, right, sharpen: float) -> torch.Tensor:
    """Plain PyTorch version of K3 on a column block, on any device: the
    woven CAS of [left | v | right] (K3's plain version), the two halo
    columns cropped from its output."""
    _check_cols_halo(v, left, right)
    out = cas_quantize_reference(torch.cat([left, v, right], dim=-1), sharpen)
    return out[..., 1:-1].contiguous()


def cas_quantize_cols_halo(v: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                           sharpen: float) -> torch.Tensor:
    """Woven CAS + quantize of one column block of an image: v (..., H, W)
    int16 Q2.14 or float32 is the block's columns, left and right (...,
    H, 1) of v's dtype the columns west of its first and east of its last
    (the block's own edge column at the image's sides).  The output equals
    the whole image's CAS on the block's columns.  CUDA tensors go through
    csrc/cas_rows.cu's kernel at u = 1, which reads the halo columns
    through pointers (identical on every pixel to the plain version); CPU
    tensors take the plain version."""
    _check_cols_halo(v, left, right)
    if v.device.type == "cpu":
        return cas_quantize_cols_halo_reference(v, left, right, sharpen)
    H, W = v.shape[-2:]
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    if v.numel() == 0:
        return out
    _launch("vkr_cas_woven_halo_cols", v.device, v.data_ptr(), left.data_ptr(),
            right.data_ptr(), out.data_ptr(), v.numel() // (H * W), H, W,
            int(v.dtype == torch.int16), float(sharpen))
    cas_quantize_cols_halo.launches += 1
    return out


cas_quantize_cols_halo.launches = 0


# ---------------------------------------------------------------------------
# K2: rows-parity CAS (u=2)
# ---------------------------------------------------------------------------


def cas_parity_planes_u2_reference(U, O, sharpen: float):
    """Plain PyTorch version of the rows-parity CAS kernel, on any device:
    weave sample rows U and odd rows O (..., h, W) to (..., 2h, W) in their
    stored dtype, run the woven CAS, split into even rows E and odd rows D."""
    _check("rows-parity CAS", (U, O))
    h, W = U.shape[-2:]
    v = torch.stack([U, O], dim=-2).reshape(U.shape[:-2] + (2 * h, W))
    out = cas_quantize_reference(v, sharpen)
    return out[..., 0::2, :].contiguous(), out[..., 1::2, :].contiguous()


def cas_parity_planes_u2(U, O, sharpen: float):
    """u=2 rows-parity fused CAS: sample rows U and odd rows O (..., h, W),
    int16 Q2.14 or float32, to the uint8 even-row and odd-row planes (E, D)
    of the same shape.  CUDA tensors go through csrc/cas_rows.cu's kernel
    at u = 2, which writes the woven rows to E and D (identical on every
    pixel to the plain version), CPU tensors take the plain version."""
    _check("rows-parity CAS", (U, O))
    if U.device.type == "cpu":
        return cas_parity_planes_u2_reference(U, O, sharpen)
    h, W = U.shape[-2:]
    E, D = (torch.empty(U.shape, dtype=torch.uint8, device=U.device) for _ in range(2))
    if U.numel() == 0:
        return E, D
    ptrs = (U.data_ptr(), O.data_ptr())
    _launch("vkr_cas_parity_u2", U.device, *ptrs, E.data_ptr(), D.data_ptr(),
            U.numel() // (h * W), h, W, int(U.dtype == torch.int16), float(sharpen))
    cas_parity_planes_u2.launches += 1
    cas_parity_planes_u2.staging = staging_form(W * U.element_size(), ptrs)
    return E, D


cas_parity_planes_u2.launches = 0
cas_parity_planes_u2.staging = None


# ---------------------------------------------------------------------------
# K1: quad-parity CAS (u=2)
# ---------------------------------------------------------------------------


def cas_parity4_planes_u2_reference(P00, P01, P10, P11, sharpen: float):
    """Plain PyTorch version of the quad CAS kernel, on any device: weave
    the four planes P[ry][rx] (..., h, Wh) to (..., 2h, 2Wh) in their
    stored dtype, run the woven CAS, split into the four parity planes."""
    planes = (P00, P01, P10, P11)
    _check("quad CAS", planes)
    h, Wh = P00.shape[-2:]
    v = torch.stack(
        [torch.stack([P00, P01], dim=-1), torch.stack([P10, P11], dim=-1)], dim=-3
    ).reshape(P00.shape[:-2] + (2 * h, 2 * Wh))
    out = cas_quantize_reference(v, sharpen)
    return tuple(
        out[..., ry::2, rx::2].contiguous()
        for ry, rx in ((0, 0), (0, 1), (1, 0), (1, 1))
    )


def cas_parity4_planes_u2(P00, P01, P10, P11, sharpen: float):
    """u=2 quad-parity fused CAS: four pre-CAS planes (..., h, Wh), int16
    Q2.14 or float32, to four uint8 planes of the same shape.  CUDA tensors
    go through csrc/cas_grid.cu's U = 2 instance (identical on every pixel
    to the plain version), CPU tensors take the plain version."""
    planes = (P00, P01, P10, P11)
    _check("quad CAS", planes)
    if P00.device.type == "cpu":
        return cas_parity4_planes_u2_reference(*planes, sharpen)
    h, Wh = P00.shape[-2:]
    outs = tuple(torch.empty(P00.shape, dtype=torch.uint8, device=P00.device)
                 for _ in range(4))
    if P00.numel() == 0:
        return outs
    ptrs = [p.data_ptr() for p in planes]
    _launch("vkr_cas_quad_u2", P00.device, *ptrs, *(o.data_ptr() for o in outs),
            P00.numel() // (h * Wh), h, Wh, int(P00.dtype == torch.int16),
            float(sharpen))
    cas_parity4_planes_u2.launches += 1
    cas_parity4_planes_u2.staging = staging_form(Wh * P00.element_size(), ptrs)
    return outs


cas_parity4_planes_u2.launches = 0
cas_parity4_planes_u2.staging = None


# ---------------------------------------------------------------------------
# K4: grid-parity CAS (u x u phase planes)
# ---------------------------------------------------------------------------

GRID_MAX_U = 8  # csrc/cas_grid.cu kMaxU


def cas_parity_grid_planes_reference(planes, u: int, sharpen: float):
    """Plain PyTorch version of the grid CAS kernel, on any device: weave
    the u*u planes P[ry][rx] (row-major, each (..., h, W)) to (..., u*h,
    u*W) in their stored dtype, run the woven CAS, split into the u*u
    phase planes."""
    planes = tuple(planes)
    _check("grid CAS", planes)
    out = cas_quantize_reference(weave_grid(planes, u), sharpen)
    return tuple(out[..., ry::u, rx::u].contiguous() for ry in range(u) for rx in range(u))


def cas_parity_grid_planes(planes, u: int, sharpen: float):
    """u-generic grid-parity fused CAS: u*u pre-CAS phase planes (row-major
    (ry, rx), each (..., h, W)), int16 Q2.14 or float32, to u*u uint8
    planes of the same shape.  CUDA tensors go through csrc/cas_grid.cu
    (u <= GRID_MAX_U; one kernel instance per u and dtype, 16-byte staging
    copies where W * itemsize % 16 == 0 and every plane is 16-byte aligned,
    32-bit stores where W % 4 == 0), identical on every pixel to the plain
    version; CPU tensors take the plain version."""
    planes = tuple(planes)
    if len(planes) != u * u:
        raise ValueError(f"expected {u * u} planes for u={u}, got {len(planes)}")
    _check("grid CAS", planes)
    p0 = planes[0]
    if p0.device.type == "cpu":
        return cas_parity_grid_planes_reference(planes, u, sharpen)
    if not 1 <= u <= GRID_MAX_U:
        raise ValueError(f"the grid CAS kernel takes 1 <= u <= {GRID_MAX_U}, got {u}")
    h, W = p0.shape[-2:]
    outs = tuple(torch.empty(p0.shape, dtype=torch.uint8, device=p0.device) for _ in planes)
    if p0.numel() == 0:
        return outs
    ptrs = ctypes.c_void_p * len(planes)
    _launch("vkr_cas_grid", p0.device,
            ptrs(*(p.data_ptr() for p in planes)), ptrs(*(o.data_ptr() for o in outs)),
            u, p0.numel() // (h * W), h, W, int(p0.dtype == torch.int16), float(sharpen))
    cas_parity_grid_planes.launches += 1
    return outs


cas_parity_grid_planes.launches = 0


# ---------------------------------------------------------------------------
# K5: fused row weave + woven CAS (integer u >= 2 row-split form)
# ---------------------------------------------------------------------------


def _check_rows(U, O, u: int) -> None:
    if int(u) != u or u < 2:
        raise ValueError(f"the fused rows CAS takes an integer u >= 2, got {u}")
    _check("fused rows CAS", (U,))
    h, W = U.shape[-2:]
    _check("fused rows CAS", (U, O), (U.shape, U.shape[:-2] + (h * (u - 1), W)))


def cas_quantize_rows_u_reference(U, O, u: int, sharpen: float) -> torch.Tensor:
    """Plain PyTorch version of the fused rows CAS kernel, on any device:
    weave sample rows U (..., h, W) and non-sample rows O (..., h(u-1), W),
    O[t(u-1)+k] = out[ut+k+1], to (..., uh, W) in their stored dtype and run
    the woven CAS."""
    _check_rows(U, O, u)
    return cas_quantize_reference(weave_rows(U, O, int(u)), sharpen)


def cas_quantize_rows_u(U, O, u: int, sharpen: float) -> torch.Tensor:
    """Fused row weave + CAS + quantize: sample rows U (..., h, W) and
    non-sample rows O (..., h(u-1), W), both int16 Q2.14 or both float32,
    to the woven (..., uh, W) uint8 image; any integer u >= 2.  CUDA
    tensors go through csrc/cas_rows.cu, CPU tensors take the plain
    version."""
    _check_rows(U, O, u)
    if U.device.type == "cpu":
        return cas_quantize_rows_u_reference(U, O, u, sharpen)
    u = int(u)
    h, W = U.shape[-2:]
    out = torch.empty(U.shape[:-2] + (u * h, W), dtype=torch.uint8, device=U.device)
    if U.numel() == 0:
        return out
    _launch("vkr_cas_rows_u", U.device, U.data_ptr(), O.data_ptr(), out.data_ptr(),
            U.numel() // (h * W), h, W, u, int(U.dtype == torch.int16), float(sharpen))
    cas_quantize_rows_u.launches += 1
    return out


cas_quantize_rows_u.launches = 0


# ---------------------------------------------------------------------------
# K6: woven CAS over row blocks with per-block halo rows (f32)
# ---------------------------------------------------------------------------


def _check_f32(what: str, v: torch.Tensor) -> None:
    if v.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 image, got {v.dtype}")
    _check(what, (v,))


def _block_rows(bh) -> int:
    if int(bh) != bh or bh < 1:
        raise ValueError(f"block_rows must be an integer >= 1, got {bh}")
    return int(bh)


def blocked_halo_rows(v: torch.Tensor, bh: int):
    """The one-row halos of K6's row blocks, the JAX wrapper's clamped row
    gather (cas_pallas.py:2446-2448): for v (..., H, W) and nb = ceil(H/bh)
    blocks, top[..., i, :] = v[..., max(i*bh - 1, 0), :] and bot[..., i, :]
    = v[..., min((i+1)*bh, H-1), :], each (..., nb, W) and contiguous.
    Only the first top row and the last bot row clamp, so each is a
    concatenation of strided row slices: no index vectors to build."""
    bh = _block_rows(bh)
    H = v.shape[-2]
    top = torch.cat([v[..., :1, :], v[..., bh - 1:H - 1:bh, :]], dim=-2)
    bot = torch.cat([v[..., bh::bh, :], v[..., -1:, :]], dim=-2)
    return top, bot


def _check_blocked(v, top, bot, bh) -> int:
    _check_f32("blocked CAS", v)
    bh = _block_rows(bh)
    H, W = v.shape[-2:]
    halo = v.shape[:-2] + (-(-H // bh), W)
    _check("blocked CAS", (v, top, bot), (v.shape, halo, halo))
    return bh


def cas_quantize_blocked_reference(v, top, bot, bh: int, sharpen: float) -> torch.Tensor:
    """Plain PyTorch version of the blocked CAS kernel, on any device, with
    the kernel's arguments: v (..., H, W) float32 cut into blocks of bh
    rows, and the blocks' halo rows top, bot (..., ceil(H/bh), W).  Inside
    a block the north and south neighbours are v's rows; the north of a
    block's first row is its top row and the south of its last valid row
    its bot row, so a wrong halo shows.  The blend is the sqrt(num/den)
    form of _cas_blk_kernel (cas_pallas.py:2378-2424)."""
    bh = _check_blocked(v, top, bot, bh)
    H, W = v.shape[-2:]
    L = _clip_len(v.reshape(-1, H, W))
    Lt, Lb = (_clip_len(t.reshape(L.shape[0], -1, W)) for t in (top, bot))
    y = torch.arange(H, device=v.device)
    blk = y // bh
    first = (y % bh == 0)[:, None]
    last = ((y % bh == bh - 1) | (y == H - 1))[:, None]
    n = torch.where(first, Lt[:, blk], L[:, (y - 1).clamp(min=0)])
    s = torch.where(last, Lb[:, blk], L[:, (y + 1).clamp(max=H - 1)])
    return _stencil_u8(L, n, s, sharpen, divide=True).reshape(v.shape)


def cas_quantize_blocked_rows(v, top, bot, bh: int, sharpen: float) -> torch.Tensor:
    """K6 with its kernel's own arguments, those of its plain version
    cas_quantize_blocked_reference: v (..., H, W) float32 in blocks of bh
    rows and the blocks' halo rows top, bot (..., ceil(H/bh), W) -> uint8
    (..., H, W).  CUDA tensors go through csrc/cas_rows.cu's block-local
    instance, which reads top and bot through pointers (identical on every
    pixel to the plain version), CPU tensors take the plain version.  The
    one launch site of K6, for the two wrappers below too: its launches
    count in cas_quantize_blocked.launches."""
    bh = _check_blocked(v, top, bot, bh)
    if v.device.type == "cpu":
        return cas_quantize_blocked_reference(v, top, bot, bh, sharpen)
    H, W = v.shape[-2:]
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    if v.numel() == 0:
        return out
    _launch("vkr_cas_blocked", v.device, v.data_ptr(), top.data_ptr(), bot.data_ptr(),
            out.data_ptr(), v.numel() // (H * W), H, W, bh, float(sharpen))
    cas_quantize_blocked.launches += 1
    return out


def cas_quantize_blocked(v: torch.Tensor, sharpen: float, block_rows: int = 64) -> torch.Tensor:
    """Blocked woven CAS + quantize of a whole image: (..., H, W) float32 ->
    uint8 of the same shape, in blocks of block_rows rows whose halo rows
    are gathered first (blocked_halo_rows, two row-slice copies on the
    card); the image's own edge rows are the outer halos (clamp to edge).
    The output does not depend on block_rows."""
    _check_f32("blocked CAS", v)
    bh = _block_rows(block_rows)
    return cas_quantize_blocked_rows(v, *blocked_halo_rows(v, bh), bh, sharpen)


def cas_quantize_blocked_halo(v: torch.Tensor, top_row: torch.Tensor, bot_row: torch.Tensor,
                              sharpen: float, block_rows: int | None = None) -> torch.Tensor:
    """K6 on one shard of a row-sharded image: v (..., H, W) float32 is the
    shard's rows, top_row and bot_row (..., 1, W) float32 the previous
    shard's last row and the next shard's first (the shard's own edge row
    at the image's top and bottom).  The output equals the whole image's
    CAS on the shard's rows.  By default the shard is one block, whose
    halo rows top_row and bot_row are: the kernel reads them where they
    lie, and its block-local bands still spread the shard over the card.
    With block_rows, blocks of that many rows, their inner halo rows
    gathered from v (blocked_halo_rows)."""
    _check_f32("blocked CAS", v)
    H = v.shape[-2]
    bh = max(H, 1) if block_rows is None else _block_rows(block_rows)
    edge = v.shape[:-2] + (1, v.shape[-1])
    _check("blocked CAS halo", (v, top_row, bot_row), (v.shape, edge, edge))
    if bh >= H:
        return cas_quantize_blocked_rows(v, top_row, bot_row, bh, sharpen)
    top, bot = blocked_halo_rows(v, bh)
    top[..., :1, :] = top_row
    bot[..., -1:, :] = bot_row
    return cas_quantize_blocked_rows(v, top, bot, bh, sharpen)


cas_quantize_blocked.launches = 0


# ---------------------------------------------------------------------------
# K7: woven CAS in one persistent launch (f32)
# ---------------------------------------------------------------------------


def cas_quantize_mono_reference(v: torch.Tensor, sharpen: float) -> torch.Tensor:
    """Plain PyTorch version of the persistent CAS kernel, on any device:
    K3's arithmetic (_cas_band) on a float32 (..., H, W) image."""
    _check_f32("mono CAS", v)
    return cas_quantize_reference(v, sharpen)


def cas_quantize_mono(v: torch.Tensor, sharpen: float, block_rows: int = 128) -> torch.Tensor:
    """Woven CAS + quantize in one persistent launch: (..., H, W) float32 ->
    uint8 of the same shape.  On the card the image is cut into segments
    of block_rows rows (any integer >= 1) on strips of 128 columns, and
    each consumer warp streams a balanced run of them down its strips
    (csrc/stream_pipeline.cuh): block_rows sets how finely the runs
    balance, never the output.  CUDA tensors go through csrc/cas_mono.cu,
    CPU tensors take the plain version.  The output equals cas_quantize's."""
    _check_f32("mono CAS", v)
    bh = _block_rows(block_rows)
    if v.device.type == "cpu":
        return cas_quantize_mono_reference(v, sharpen)
    H, W = v.shape[-2:]
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    if v.numel() == 0:
        return out
    _launch("vkr_cas_mono", v.device, v.data_ptr(), out.data_ptr(),
            v.numel() // (H * W), H, W, bh, float(sharpen))
    cas_quantize_mono.launches += 1
    cas_quantize_mono.staging = stream_form(W, v.data_ptr(), out.data_ptr())
    return out


cas_quantize_mono.launches = 0
cas_quantize_mono.staging = None
