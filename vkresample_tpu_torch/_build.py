"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into one
shared library with a plain C interface, which is loaded with ctypes.  The
library lands in ``vkresample_tpu_torch/build/`` under a name derived from
the sources' content and the flags, so an edited source is never shadowed
by a stale binary and a second process reuses the first one's build.
Nothing here runs at import time: the first kernel launch builds.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
# what the last load did, for set-up reporting (chip_smoke.py)
last_build = {"compiled": False, "seconds": 0.0, "path": None}


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
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libvkr_kernels_{digest.hexdigest()[:16]}.so")


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
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    last_build.update(compiled=True, seconds=time.perf_counter() - t0, path=out)
    return out


def load_kernels() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.vkr_cas_quad_u2.restype = ctypes.c_int
            lib.vkr_cas_quad_u2.argtypes = (
                [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p]
            )
            _lib = lib
        return _lib
