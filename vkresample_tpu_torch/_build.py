"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (sm_90a), one
``nvcc`` per source, all started together, and the objects are linked into
one shared library with a plain C interface, which is loaded with ctypes.
The library lands in ``vkresample_tpu_torch/build/`` under a name derived
from the content of the sources, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is never shadowed by a stale binary and a
second process reuses the first one's build.  Nothing here runs at import
time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
# what the last load did, for set-up reporting (chip_smoke.py)
last_build = {"compiled": False, "seconds": 0.0, "path": None}

# The library's C entry points, each defined by one extern "C" function in
# one csrc/*.cu, and their arguments before the stream, which every entry
# takes last; each returns a cudaError_t as int.
_PTR, _PTRS, _I32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
_F32 = ctypes.c_float  # the sharpen factor
ENTRY_POINTS = {
    "vkr_cas_quad_u2": [_PTR] * 8 + [_I32] * 4 + [_F32],    # P00..P11, O00..O11; C, h, Wh, is_i16
    "vkr_cas_parity_u2": [_PTR] * 4 + [_I32] * 4 + [_F32],  # U, O, E, D; C, h, W, is_i16
    "vkr_cas_woven": [_PTR] * 2 + [_I32] * 4 + [_F32],      # v, out; C, H, W, is_i16
    "vkr_cas_grid": [_PTRS] * 2 + [_I32] * 5 + [_F32],      # in[u*u], out[u*u]; u, C, h, W, is_i16
    "vkr_cas_rows_u": [_PTR] * 3 + [_I32] * 5 + [_F32],     # U, O, out; C, h, W, u, is_i16
    "vkr_cas_blocked": [_PTR] * 4 + [_I32] * 4 + [_F32],    # v, top, bot, out; C, H, W, bh
    "vkr_cas_mono": [_PTR] * 2 + [_I32] * 4 + [_F32],       # v, out; C, H, W, bh
    "vkr_ycas_parity_u2": [_PTR] * 5 + [_I32] * 5 + [_F32],  # U, T2, YT, E, D; C, h, W, r, is_i16
    "vkr_ycas_u2": [_PTR] * 4 + [_I32] * 5 + [_F32],        # U, T2, YT, out; C, h, W, r, is_i16
    "vkr_copy_quantize_tile": [_PTR] * 2 + [_I32] * 3,      # v, out; C, H, W
    "vkr_copy_quantize_mono": [_PTR] * 2 + [_I32] * 4,      # v, out; C, H, W, bh
    "vkr_copy_quantize_rows": [_PTR] * 2 + [_I32] * 3,      # v, out; C, H, W
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if path is None and os.path.exists(default):
        path = default
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for src in _sources() + headers:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libvkr_kernels_{digest.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails.  Every process is waited for before returning."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    failed = None
    for cmd, proc in zip(cmds, procs):
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"{' '.join(cmd)} failed ({proc.returncode}):\n{log}"
    if failed is not None:
        raise RuntimeError(failed)


def build_library() -> str:
    """Compile csrc/*.cu unless the content-named library exists; returns
    its path.  The output is written under a temporary name and renamed,
    so a concurrent process never loads a half-written file."""
    out = library_path()
    if os.path.exists(out):
        last_build.update(compiled=False, seconds=0.0, path=out)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)
    last_build.update(compiled=True, seconds=time.perf_counter() - t0, path=out)
    return out


def load_kernels() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, args in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args + [ctypes.c_void_p]
            _lib = lib
        return _lib
