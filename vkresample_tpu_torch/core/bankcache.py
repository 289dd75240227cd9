"""Disk cache for plan-time bank sets (counterpart of
vkresample_tpu/core/bankcache.py).

Bank sets are built in f64 numpy on the host.  The staged sets take O(n *
n1^2 * n2) work in conv_banks (its five-operand einsum), a second or more
for an axis of 8192 and more for 16384; the cache makes the second run at
the same geometry load them from disk instead.

Layout: one .npz per bank set, keyed by a hash of (the port's cache
version, builder tag, plan geometry, precision, r2c, dtype).  Entries live
in $VKRESAMPLE_CACHE_DIR/torch when that variable is set (the JAX package's
entries sit beside them, in the directory itself, under keys of their
own), else in vkresample_tpu_torch/build/bankcache inside the checkout.
Delete the directory to clear the cache.  Writes are atomic (tmp +
rename) and an unreadable entry is rebuilt and overwritten, so the cache
can never give other banks than a build.  VKRESAMPLE_NO_BANK_CACHE=1
disables it.  Geometries with every axis below MIN_CACHED_DIM build in well
under a second and skip the disk.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Callable, Dict

import numpy as np

# the port's own version: bump when a bank builder's arithmetic changes
# what it returns for the same key
CACHE_VERSION = "torch-1"

MIN_CACHED_DIM = 4096


def cache_dir() -> str:
    d = os.environ.get("VKRESAMPLE_CACHE_DIR")
    if d:
        return os.path.join(d, "torch")
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "build", "bankcache")


def _key(tag: str, plan, dtype: str) -> str:
    blob = json.dumps([CACHE_VERSION, tag, plan.h, plan.w, float(plan.upscale),
                       plan.precision.name, bool(plan.r2c), dtype])
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def _save(path: str, banks: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in banks.items()})
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def get_or_build(tag: str, plan, dtype: str,
                 build: Callable[[], Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The bank dict of (tag, plan, dtype): from disk when a readable entry
    exists, else built (and written)."""
    if os.environ.get("VKRESAMPLE_NO_BANK_CACHE") or (
        max(plan.h, plan.w, plan.H, plan.W) < MIN_CACHED_DIM
    ):
        return build()
    path = os.path.join(cache_dir(), f"{tag}-{_key(tag, plan, dtype)}.npz")
    if os.path.exists(path):
        try:
            return _load(path)
        except Exception:
            pass  # unreadable, corrupt or foreign entry: rebuild and overwrite
    banks = build()
    try:
        _save(path, banks)
    except OSError:
        pass  # read-only disk or quota: the cache is best-effort
    return banks
