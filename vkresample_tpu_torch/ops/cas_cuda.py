"""Quad-parity fused CAS (u=2): the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of vkresample_tpu/ops/cas_pallas.py::cas_parity4_planes_u2.
Four pre-CAS parity planes P[ry][rx] (..., h, Wh), int16 Q2.14 or float32,
are the woven image V[..., 2t+ry, 2s+rx] = P[ry][rx][..., t, s]; the output
is the CAS + quantize of V, split back into four uint8 parity planes.  The
kernel is csrc/cas_quad.cu; see its header for the design.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cas import from_i16_storage

_DTYPES = (torch.int16, torch.float32)


def _check_planes(planes) -> None:
    p0 = planes[0]
    if p0.dtype not in _DTYPES:
        raise TypeError(f"quad CAS takes int16 or float32 planes, got {p0.dtype}")
    if p0.dim() < 2:
        raise ValueError(f"quad CAS planes need (..., h, Wh), got {tuple(p0.shape)}")
    for p in planes[1:]:
        if p.device != p0.device or p.dtype != p0.dtype or p.shape != p0.shape:
            raise ValueError(
                "quad CAS planes must share device, dtype and shape: "
                f"{[(str(q.device), q.dtype, tuple(q.shape)) for q in planes]}"
            )
    if any(not p.is_contiguous() for p in planes):
        raise ValueError("quad CAS planes must be contiguous")


def _blend_u8(c, nsum, minlen, maxlen, sharpen: float) -> torch.Tensor:
    """_cas_blend (cas_pallas.py:637-656): the rsqrt form with the 1e-30
    floor, then x255, clamp, truncate."""
    a, b = minlen, 1.0 - minlen
    cq, d = 1.0 - maxlen, maxlen
    pred = a * d < cq * b
    num = torch.where(pred, a, cq)
    den = torch.where(pred, b, d)
    sc = (-sharpen * num) * torch.rsqrt(torch.clamp(num * den, min=1e-30))
    out = (c + sc * nsum) / (1.0 + 4.0 * sc)
    return torch.clamp(out * 255.0, 0.0, 255.0).to(torch.int32).to(torch.uint8)


def cas_parity4_planes_u2_reference(P00, P01, P10, P11, sharpen: float):
    """Plain PyTorch version of the quad CAS kernel, on any device: weave
    to (..., 2h, 2Wh) f32, L = min(|v|, 1), edge-padded 3x3 CAS with the
    kernel's blend, quantize, split into the four parity planes."""
    planes = (P00, P01, P10, P11)
    _check_planes(planes)
    lead = P00.shape[:-2]
    h, Wh = P00.shape[-2:]
    f = [
        from_i16_storage(p) if p.dtype == torch.int16 else p
        for p in (x.reshape((-1, h, Wh)) for x in planes)
    ]
    N = f[0].shape[0]
    v = torch.stack(
        [torch.stack([f[0], f[1]], dim=-1), torch.stack([f[2], f[3]], dim=-1)],
        dim=-3,
    ).reshape(N, 2 * h, 2 * Wh)
    L = torch.clamp(v.abs(), max=1.0)
    p = F.pad(L[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    c = p[:, 1:-1, 1:-1]
    n, s = p[:, :-2, 1:-1], p[:, 2:, 1:-1]
    w, e = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    nw, ne = p[:, :-2, :-2], p[:, :-2, 2:]
    sw, se = p[:, 2:, :-2], p[:, 2:, 2:]
    mn, mx = torch.minimum, torch.maximum
    min_cross = mn(mn(n, s), mn(c, mn(w, e)))
    max_cross = mx(mx(n, s), mx(c, mx(w, e)))
    min_all = mn(min_cross, mn(mn(nw, ne), mn(sw, se)))
    max_all = mx(max_cross, mx(mx(nw, ne), mx(sw, se)))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)
    out = _blend_u8(c, (n + s) + (w + e), minlen, maxlen, sharpen)
    o4 = out.reshape(N, h, 2, Wh, 2)
    return tuple(
        o4[:, :, ry, :, rx].contiguous().reshape(lead + (h, Wh))
        for ry, rx in ((0, 0), (0, 1), (1, 0), (1, 1))
    )


def cas_parity4_planes_u2(P00, P01, P10, P11, sharpen: float):
    """u=2 quad-parity fused CAS: four pre-CAS planes (..., h, Wh), int16
    Q2.14 or float32, to four uint8 planes of the same shape.

    CUDA tensors go through the hand-written kernel (csrc/cas_quad.cu) on
    the current stream; a launch error raises.  CPU tensors take the plain
    version."""
    planes = (P00, P01, P10, P11)
    _check_planes(planes)
    if P00.device.type == "cpu":
        return cas_parity4_planes_u2_reference(*planes, sharpen)
    if P00.device.type != "cuda":
        raise ValueError(f"quad CAS runs on cuda or cpu, not {P00.device}")
    lead = P00.shape[:-2]
    h, Wh = P00.shape[-2:]
    C = P00.numel() // max(1, h * Wh)
    outs = tuple(torch.empty(P00.shape, dtype=torch.uint8, device=P00.device)
                 for _ in range(4))
    if P00.numel() == 0:
        return outs
    from .._build import load_kernels

    lib = load_kernels()
    with torch.cuda.device(P00.device):
        stream = torch.cuda.current_stream(P00.device).cuda_stream
        rc = lib.vkr_cas_quad_u2(
            *(p.data_ptr() for p in planes),
            *(o.data_ptr() for o in outs),
            C, h, Wh, int(P00.dtype == torch.int16), float(sharpen), stream,
        )
    if rc != 0:
        raise RuntimeError(f"cas_quad_u2 launch failed: cudaError_t {rc}")
    cas_parity4_planes_u2.launches += 1
    return tuple(o.reshape(lead + (h, Wh)) for o in outs)


cas_parity4_planes_u2.launches = 0
