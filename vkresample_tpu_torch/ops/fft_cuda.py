"""The cuFFT form's three kernels and its C2R call (fft/cufft.py), their
wrappers and plain PyTorch versions:

  K12 spectrum_shift  csrc/spectrum_shift.cu (vkr_spectrum_shift): the
                      frame's half spectrum relocated into the kept
                      columns of the upscaled frame's spectrum, zero band
                      included, stored y innermost for the transform
                      along y
  K13 spectrum_pad    csrc/spectrum_shift.cu (vkr_spectrum_pad): that
                      transform's output zero-padded to the C2R's W/2 + 1
                      columns, row-major, the imaginary part of column 0
                      zeroed
      c2r             cuFFT's C2R on that input, called through ctypes:
                      torch.fft.irfft copies its input before every C2R
                      (cuFFT uses it as scratch), a pass the form's
                      temporary input does not need
  K11 quad_store      csrc/quad_store.cu (vkr_quad_store): the woven
                      float32 pre-CAS image scaled and split into the four
                      parity planes K1 reads

None replaces a TPU kernel (see each source's header): the JAX
package's u = 2 routes make the parity planes in their GEMMs and never
form the spectrum.  spectrum_shift is the counterpart of VkResample's
shift shader (VkResample.cpp:476-548): G[..., r, c] = F[..., r, c] for
r < klo, F[..., r - (H - h), c] for r >= H - khi, 0 between, c < kx, as
ops/spectrum.py::assemble_big_spectrum places the same bins.  The cuFFT
form ends in a C2R whose output is the woven image in raw uint8 units;
quad_store applies the scale (1/255, the u^2 factor, the inverses'
1/(H W) and, for int16, Q2.14's 2^14, folded into one float32 factor) and
writes P[ry][rx] = x[..., ry::2, rx::2], int16 Q2.14 (round half to even,
saturating, as ops/cas.py::to_i16_storage) or float32.

Folding 2^14 into the factor changes no bit: for a float32 factor s,
round(float32(v * s) * 2^14) == round(v * float32(s * 2^14)), since a
product with a power of two is exact (short of overflow, and of results
under 2^-126, which round to 0 either way).

Each wrapper runs its kernel (c2r: cuFFT) on a CUDA tensor (on its
device's current stream; a launch error raises) and its plain version
(c2r: torch.fft.irfft) on a CPU tensor, and counts its launches in
``.launches``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .cas import I16_SCALE
from .cas_cuda import _launch

# the kernels' grid rows and grid planes (frames x channels)
MAX_GRID = 65535


def spectrum_shift_reference(F: torch.Tensor, H: int, kx: int, klo: int, khi: int):
    """Plain PyTorch version, on any device: (..., h, wf) complex64 ->
    (..., H, kx) complex64, rows [0, klo) in place, the last khi rows of F
    at the far edge, zeros between, columns [0, kx); stored y innermost,
    as the kernel stores it."""
    _check_shift(F, H, kx, klo, khi)
    h = F.shape[-2]
    G = F.new_zeros(F.shape[:-2] + (kx, H)).transpose(-1, -2)
    G[..., :klo, :] = F[..., :klo, :kx]
    if khi:
        G[..., H - khi:, :] = F[..., h - khi:, :kx]
    return G


def _check_shift(F, H, kx, klo, khi) -> None:
    _check_complex("spectrum shift", F)
    if not F.is_contiguous():
        raise ValueError("spectrum shift takes a contiguous spectrum")
    h, wf = F.shape[-2:]
    if not (0 < kx <= wf and klo >= 0 and khi >= 0 and klo + khi <= min(h, H)):
        raise ValueError(f"spectrum shift: bad geometry h={h} wf={wf} H={H} kx={kx} "
                         f"klo={klo} khi={khi}")


def _check_complex(what: str, x: torch.Tensor) -> None:
    if x.dtype != torch.complex64:
        raise TypeError(f"{what} takes complex64, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"{what} takes (..., rows, cols), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def _planes(x: torch.Tensor, what: str) -> int:
    """The planes (leading elements) of (..., rows, cols), within the grid."""
    n = x[..., 0, 0].numel()
    if n > MAX_GRID:
        raise ValueError(f"{what} takes at most {MAX_GRID} planes, got {n}")
    return n


def spectrum_shift(F: torch.Tensor, H: int, kx: int, klo: int, khi: int):
    """(..., h, wf) complex64 half spectrum -> (..., H, kx) complex64 stored
    y innermost, the layout torch.fft's transform along y reads without a
    copy (see spectrum_shift_reference).  CUDA tensors go through
    csrc/spectrum_shift.cu (identical on every value to the plain version),
    CPU tensors take the plain version."""
    _check_shift(F, H, kx, klo, khi)
    if F.device.type == "cpu":
        return spectrum_shift_reference(F, H, kx, klo, khi)
    n = _planes(F, "spectrum shift")
    G = torch.empty(F.shape[:-2] + (kx, H), dtype=F.dtype, device=F.device).transpose(-1, -2)
    if n:
        _launch("vkr_spectrum_shift", F.device, F.data_ptr(), G.data_ptr(), n, F.shape[-2],
                F.shape[-1], H, kx, klo, khi)
        spectrum_shift.launches += 1
    return G


spectrum_shift.launches = 0


def spectrum_pad_reference(g: torch.Tensor, wp: int):
    """Plain PyTorch version, on any device: (..., H, kx) complex64 ->
    (..., H, wp) contiguous complex64, g in columns [0, kx) with the
    imaginary part of column 0 zeroed, zeros past kx."""
    _check_pad(g, wp)
    P = g.new_zeros(g.shape[:-1] + (wp,))
    P[..., :g.shape[-1]] = g
    P[..., 0].imag.zero_()
    return P


def _check_pad(g, wp) -> None:
    _check_complex("spectrum pad", g)
    if not 0 < g.shape[-1] <= wp:
        raise ValueError(f"spectrum pad: {g.shape[-1]} columns do not fit in {wp}")


def spectrum_pad(g: torch.Tensor, wp: int):
    """(..., H, kx) complex64, the y inverse's output -> the C2R's input
    (..., H, wp) contiguous (see spectrum_pad_reference).  CUDA tensors go
    through csrc/spectrum_shift.cu, which reads g stored y innermost (as
    torch.fft's transform along y leaves it; any other layout is first
    copied to it), CPU tensors take the plain version."""
    _check_pad(g, wp)
    if g.device.type == "cpu":
        return spectrum_pad_reference(g, wp)
    n = _planes(g, "spectrum pad")
    gt = g.transpose(-1, -2)
    if not gt.is_contiguous():
        gt = gt.contiguous()
    H, kx = g.shape[-2:]
    P = torch.empty(g.shape[:-1] + (wp,), dtype=g.dtype, device=g.device)
    if n:
        _launch("vkr_spectrum_pad", g.device, gt.data_ptr(), P.data_ptr(), n, H, kx, wp)
        spectrum_pad.launches += 1
    return P


spectrum_pad.launches = 0


# ---------------------------------------------------------------------------
# the C2R, called in cuFFT without torch.fft's copy of its input
# ---------------------------------------------------------------------------

_CUFFT_C2R = 0x2C  # cufft.h: cufftType CUFFT_C2R
_cufft = []  # [the bound library], once found
_c2r_plans = {}  # (device index, W, batch) -> (cufftHandle, its workspace tensor)


def pick_cufft(mapped, torch_dir: str):
    """Of the libcufft paths a process has mapped, the one torch loaded:
    the one under torch's own install (its lib directory, or the
    site-packages its wheels put cuFFT in), else the only one mapped;
    None when none is mapped or no one of several is torch's."""
    found = sorted({p for p in mapped if os.path.basename(p).startswith("libcufft.so")})
    site = os.path.dirname(os.path.normpath(torch_dir)) + os.sep
    own = [p for p in found if p.startswith(site)]
    if len(own) == 1:
        return own[0]
    return found[0] if len(found) == 1 and not own else None


def _mapped_paths():
    with open("/proc/self/maps") as maps:
        return [line.split()[-1] for line in maps if line.count("/")]


def _cufft_lib(device):
    """The cuFFT shared library torch.fft uses, bound with ctypes: found in
    this process's memory map (pick_cufft), after a transform on `device`
    has made torch load it.  Raises when there is none to call (a torch
    build that links cuFFT into itself)."""
    if not _cufft:
        import ctypes

        path = pick_cufft(_mapped_paths(), os.path.dirname(torch.__file__))
        if path is None:
            # torch loads cuFFT at its first transform on the card
            torch.fft.irfft(torch.zeros(2, dtype=torch.complex64, device=device))
            path = pick_cufft(_mapped_paths(), os.path.dirname(torch.__file__))
        if path is None:
            raise RuntimeError("C2R: no libcufft of torch's in this process to call")
        lib = ctypes.CDLL(path)
        i32, ptr, size_p = ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        int_p = ctypes.POINTER(ctypes.c_int)
        for fn, args in (("cufftCreate", [int_p]), ("cufftSetAutoAllocation", [i32, i32]),
                         ("cufftMakePlanMany", [i32, i32, int_p, int_p, i32, i32, int_p, i32,
                                                i32, i32, i32, size_p]),
                         ("cufftSetWorkArea", [i32, ptr]), ("cufftSetStream", [i32, ptr]),
                         ("cufftExecC2R", [i32, ptr, ptr])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i32
        _cufft.append(lib)
    return _cufft[0]


def _cufft_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cufftResult {rc}")


def _c2r_plan(device, W: int, batch: int):
    """A cuFFT plan of `batch` C2R transforms of length W, basic layout
    (W/2 + 1 complex in, W real out, one after another), its workspace
    allocated by torch on `device`; made once per (device, W, batch)."""
    import ctypes

    key = (device.index, W, batch)
    if key not in _c2r_plans:
        lib = _cufft_lib(device)
        handle, work = ctypes.c_int(), ctypes.c_size_t()
        _cufft_check(lib.cufftCreate(ctypes.byref(handle)), "cufftCreate")
        _cufft_check(lib.cufftSetAutoAllocation(handle, 0), "cufftSetAutoAllocation")
        n = (ctypes.c_int * 1)(W)
        _cufft_check(lib.cufftMakePlanMany(handle, 1, n, None, 1, 0, None, 1, 0,
                                           _CUFFT_C2R, batch, ctypes.byref(work)),
                     "cufftMakePlanMany")
        space = torch.empty(max(1, work.value), dtype=torch.uint8, device=device)
        _cufft_check(lib.cufftSetWorkArea(handle, space.data_ptr()), "cufftSetWorkArea")
        _c2r_plans[key] = (handle, space)
    return _c2r_plans[key]


def c2r(P: torch.Tensor, W: int) -> torch.Tensor:
    """(..., W/2 + 1) complex64 half spectra -> (..., W) float32, the
    unnormalized inverse (torch.fft.irfft(P, n=W, norm="forward")).  A CUDA
    P is transformed by cuFFT directly, on P's device whichever device is
    current, and overwritten (cuFFT's C2R uses its input as scratch):
    torch.fft copies its input first to keep it, a pass the cuFFT form does
    not need.  A CPU P takes torch.fft."""
    _check_complex("C2R", P)
    if P.shape[-1] != W // 2 + 1 or not P.is_contiguous():
        raise ValueError(f"C2R takes contiguous (..., {W // 2 + 1}), got {tuple(P.shape)}")
    if P.device.type == "cpu":
        return torch.fft.irfft(P, n=W, dim=-1, norm="forward")
    v = torch.empty(P.shape[:-1] + (W,), dtype=torch.float32, device=P.device)
    batch = P[..., 0].numel()
    if batch == 0:
        return v
    # the plan, its workspace and the stream are P.device's: a plan made or
    # run while another device is current fails (the dp mode runs every
    # device's share from one thread)
    with torch.cuda.device(P.device):
        handle, _ = _c2r_plan(P.device, W, batch)
        lib = _cufft_lib(P.device)
        _cufft_check(lib.cufftSetStream(handle, torch.cuda.current_stream(P.device).cuda_stream),
                     "cufftSetStream")
        _cufft_check(lib.cufftExecC2R(handle, P.data_ptr(), v.data_ptr()), "cufftExecC2R")
    c2r.launches += 1
    return v


c2r.launches = 0


def _check(v: torch.Tensor) -> None:
    if v.dtype != torch.float32:
        raise TypeError(f"quad store takes a float32 image, got {v.dtype}")
    if v.dim() < 2 or v.shape[-2] % 2 or v.shape[-1] % 2:
        raise ValueError(f"quad store takes (..., 2h, 2w), got {tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError("quad store takes a contiguous image")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quad store runs on cuda or cpu, not {v.device}")


def store_factor(scale: float, i16: bool) -> float:
    """The one float32 factor the pass multiplies by: scale, times
    Q2.14's 2^14 for int16 storage."""
    return float(np.float32(scale) * np.float32(I16_SCALE if i16 else 1.0))


def quad_store_reference(v: torch.Tensor, scale: float, i16: bool):
    """Plain PyTorch version, on any device: (..., 2h, 2w) float32 ->
    (P00, P01, P10, P11), each (..., h, w), of f(v) = v * factor (float32),
    rounded half to even and saturated to int16 when i16."""
    _check(v)
    f = v * store_factor(scale, i16)
    if i16:
        f = torch.clamp(torch.round(f), -32768.0, 32767.0).to(torch.int16)
    return tuple(f[..., ry::2, rx::2].contiguous() for ry in (0, 1) for rx in (0, 1))


def quad_store(v: torch.Tensor, scale: float, i16: bool):
    """(..., 2h, 2w) float32 -> the four parity planes (..., h, w) of v *
    scale, int16 Q2.14 (i16) or float32.  CUDA tensors go through
    csrc/quad_store.cu (identical on every value to the plain version), CPU
    tensors take the plain version."""
    _check(v)
    if v.device.type == "cpu":
        return quad_store_reference(v, scale, i16)
    H2, W2 = v.shape[-2:]
    h, w = H2 // 2, W2 // 2
    n = v.numel() // (H2 * W2) if v.numel() else 0
    if h > MAX_GRID or n > MAX_GRID:
        raise ValueError(f"quad store takes at most {MAX_GRID} plane rows and planes, "
                         f"got {h} and {n}")
    # one allocation for the four planes: each is a contiguous slice of it
    buf = torch.empty((4,) + v.shape[:-2] + (h, w),
                      dtype=torch.int16 if i16 else torch.float32, device=v.device)
    planes = tuple(buf.unbind(0))
    if n == 0 or h == 0 or w == 0:
        return planes
    _launch("vkr_quad_store", v.device, v.data_ptr(), *(p.data_ptr() for p in planes),
            n, h, w, int(i16), store_factor(scale, i16))
    quad_store.launches += 1
    return planes


quad_store.launches = 0
