"""PNG I/O for the port (counterpart of vkresample_tpu/io/png.py).

Two codecs, same pixel semantics (decode forces 8-bit RGB):

- native: the port's own copy of the JAX package's C++ codec,
  io/native/pngio.cpp, compiled with g++ against libpng into
  vkresample_tpu_torch/build/ and bound with ctypes.  Its planar encoders
  interleave the channels, and the parity and grid ones weave the uint8
  planes, inside their row loops.
- zlib: a small stdlib PNG codec for machines without libpng.  Its reader
  takes every color type and bit depth, interlaced or not, to what the
  native reader's libpng transforms give: palette entries looked up in
  PLTE, 1/2/4-bit gray scaled to 0-255, 16-bit samples cut to their high
  byte, alpha and tRNS dropped.  Its writer writes 8-bit RGB; planes are
  woven on the host first.

The first call prints which codec is in use.  This is host I/O only; it
never touches the device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PNGIO_SRC = os.path.join(_PKG_DIR, "io", "native", "pngio.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")

_lock = threading.Lock()
_lib = None
_codec: Optional[str] = None  # "native" or "zlib", decided at first use


def _build_native() -> Optional[str]:
    """g++ build of pngio.cpp (content-named, atomic rename); None when the
    source, the compiler or libpng is missing."""
    if not os.path.exists(_PNGIO_SRC) or shutil.which("g++") is None:
        return None
    with open(_PNGIO_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libvkrpng_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
         _PNGIO_SRC, "-lpng", "-lz", "-lpthread"],
        capture_output=True, timeout=300,
    )
    if proc.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def _native():
    """The ctypes-bound native codec, or None (zlib fallback); prints the
    codec choice once."""
    global _lib, _codec
    with _lock:
        if _codec is None:
            path = _build_native()
            try:
                lib = ctypes.CDLL(path) if path is not None else None
            except OSError:  # built elsewhere, libpng missing here
                lib = None
            if lib is not None:
                u8p = ctypes.POINTER(ctypes.c_ubyte)
                lib.vkr_png_decode.restype = u8p
                lib.vkr_png_decode.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                lib.vkr_png_encode.restype = ctypes.c_int
                lib.vkr_png_encode.argtypes = [
                    ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int,
                ]
                # planar encoders: path, n planes, width, height, level
                for name, n in (
                    ("vkr_png_encode_planar", 3),
                    ("vkr_png_encode_planar_parity", 2),
                    ("vkr_png_encode_planar_parity4", 4),
                ):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = (
                        [ctypes.c_char_p] + [u8p] * n
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_int]
                    )
                lib.vkr_png_encode_planar_grid.restype = ctypes.c_int
                lib.vkr_png_encode_planar_grid.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(u8p), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ]
                lib.vkr_free.restype = None
                lib.vkr_free.argtypes = [ctypes.c_void_p]
                _lib = lib
            _codec = "native" if _lib is not None else "zlib"
            print(
                "PNG codec: native libpng (vkresample_tpu_torch/io/native/pngio.cpp)"
                if _lib is not None
                else "PNG codec: stdlib zlib fallback (libpng unavailable)"
            )
        return _lib


def _encode_err(rc, path) -> str:
    d = os.path.dirname(str(path)) or "."
    hint = "" if os.path.isdir(d) else f" (output directory {d!r} does not exist)"
    return f"PNG encode failed ({rc}): {path}{hint}"


# ---------------------------------------------------------------------------
# zlib fallback codec
# ---------------------------------------------------------------------------

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


def _paeth_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _avg_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter(lines: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Undo the filters of one image or Adam7 pass: (rows, 1 + stride)
    scanlines, each led by its filter type, -> (rows, stride) bytes; the
    first row's prior row is zeros."""
    rows, stride = lines.shape[0], lines.shape[1] - 1
    out = np.empty((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(rows):
        ftype, line = lines[y, 0], lines[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte of a pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:
            cur = np.frombuffer(_avg_row(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in {path}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines (n, stride) -> (n, width, channels) uint8
    samples: 1/2/4-bit values unpacked from the most significant bits, the
    high byte of each big-endian 16-bit sample."""
    n = rows.shape[0]
    if depth == 16:
        return rows[:, 0::2].reshape(n, width, channels)
    if depth == 8:
        return rows.reshape(n, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(n, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :, None]


def _zlib_read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, ihdr, plte = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"truncated PNG file ({kind.decode('latin-1')} chunk): {path}")
        pos += 12 + n
        if kind == b"IHDR" and n == 13:
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, color, _, _, interlace = ihdr
    if depth not in _DEPTHS.get(color, ()) or interlace not in (0, 1) or w == 0 or h == 0:
        raise ValueError(f"unsupported PNG: {path} is {w}x{h}, bit depth {depth}, "
                         f"color type {color}, interlace {interlace}")
    if color == 3 and plte is None:
        raise ValueError(f"palette PNG without PLTE: {path}")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt or truncated PNG image data in {path}: {e}") from e
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)  # filter unit: bytes per pixel, at least 1
    px = np.empty((h, w, ch), np.uint8)
    pos = 0
    for y0, x0, dy, dx in _ADAM7 if interlace else ((0, 0, 1, 1),):
        ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if ph == 0 or pw == 0:  # an empty pass of a tiny image has no scanlines
            continue
        stride = (pw * ch * depth + 7) // 8
        size = ph * (stride + 1)
        if pos + size > len(raw):
            raise ValueError(f"truncated PNG image data in {path}")
        rows = _unfilter(raw[pos : pos + size].reshape(ph, stride + 1), bpp, path)
        px[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += size
    if color == 3:  # palette: indices past the PLTE entries read black, as in libpng
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[: len(plte) // 3 * 3].reshape(-1, 3)[:256]
        pal[: len(entries)] = entries
        return pal[px[:, :, 0]]
    if ch <= 2:  # gray (+alpha) -> RGB
        g = px[:, :, 0]
        if depth < 8:
            g = g * np.uint8(255 // ((1 << depth) - 1))  # x255, x85, x17
        return np.repeat(g[:, :, None], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    )


def _zlib_write(path: str, img: np.ndarray, level: int) -> None:
    h, w, _ = img.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to (h, w, 3) uint8 RGB (req_comp=3 semantics of the
    reference's stbi_load call).  FileNotFoundError when there is no file
    at `path`; ValueError naming the fault when the file does not decode."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Image not found: {path}")
    lib = _native()
    if lib is not None:
        w, h = ctypes.c_int(), ctypes.c_int()
        buf = lib.vkr_png_decode(os.fsencode(path), ctypes.byref(w), ctypes.byref(h))
        if not buf:
            _zlib_read(path)  # raises naming what is wrong with the file
            raise ValueError(f"libpng cannot decode {path}")
        try:
            arr = np.ctypeslib.as_array(buf, shape=(w.value * h.value * 3,)).copy()
        finally:
            lib.vkr_free(buf)
        return arr.reshape(h.value, w.value, 3)
    return _zlib_read(path)


def write_png(path: str, img: np.ndarray, compression_level: int = 6) -> None:
    """Encode (h, w, 3) uint8 RGB to a PNG file."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {img.shape}")
    lib = _native()
    if lib is not None:
        h, w = img.shape[:2]
        rc = lib.vkr_png_encode(
            os.fsencode(path), img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w, h, compression_level,
        )
        if rc != 0:
            raise OSError(_encode_err(rc, path))
        return
    try:
        _zlib_write(path, img, compression_level)
    except OSError as e:
        raise OSError(_encode_err(e.errno, path)) from e


def weave4_host(p00, p01, p10, p11) -> np.ndarray:
    """Host assembly of quad-parity planes (..., C, h, w) into
    (..., C, 2h, 2w) uint8."""
    c, h2, wh = p00.shape[-3:]
    out = np.empty(p00.shape[:-3] + (c, 2 * h2, 2 * wh), np.uint8)
    out[..., 0::2, 0::2] = p00
    out[..., 0::2, 1::2] = p01
    out[..., 1::2, 0::2] = p10
    out[..., 1::2, 1::2] = p11
    return out


def weave_grid_host(planes, u: int) -> np.ndarray:
    """Host assembly of u*u grid-parity planes (row-major (ry, rx), each
    (..., C, h, w)) into (..., C, u*h, u*w) uint8."""
    ps = [np.asarray(p, np.uint8) for p in planes]
    c, h, w = ps[0].shape[-3:]
    out = np.empty(ps[0].shape[:-3] + (c, u * h, u * w), np.uint8)
    for i, p in enumerate(ps):
        out[..., i // u::u, i % u::u] = p
    return out


def _encode_planes(entry: str, path: str, planes, width: int, height: int,
                   compression_level: int) -> bool:
    """Encode with the native planar encoder `entry`; False when the zlib
    codec is in use (the caller weaves on the host)."""
    lib = _native()
    if lib is None:
        return False
    rc = getattr(lib, entry)(
        os.fsencode(path),
        *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)) for p in planes],
        width, height, compression_level,
    )
    if rc != 0:
        raise OSError(_encode_err(rc, path))
    return True


def _u8_planes(planes, n: int, what: str):
    ps = [np.ascontiguousarray(p, np.uint8) for p in planes]
    if len(ps) != n or any(
        p.shape != ps[0].shape or p.ndim != 3 or p.shape[0] != 3 for p in ps
    ):
        raise ValueError(f"expected {what}")
    return ps


def write_png_planar(path: str, img: np.ndarray, compression_level: int = 6) -> None:
    """Encode a PLANAR (3, h, w) uint8 RGB image, the woven routes' device
    layout.  The native codec interleaves the channels in its row loop."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[0] != 3:
        raise ValueError(f"expected (3, h, w) uint8, got {img.shape}")
    _, h, w = img.shape
    if not _encode_planes("vkr_png_encode_planar", path, list(img), w, h,
                          compression_level):
        write_png(path, np.moveaxis(img, 0, -1), compression_level)


def write_png_planar_parity(path: str, e: np.ndarray, d: np.ndarray,
                            compression_level: int = 6) -> None:
    """Encode from rows-parity planes: e (3, H/2, W) the even output rows,
    d the odd ones.  The native codec weaves the rows in its row loop; the
    zlib codec weaves on the host."""
    e, d = _u8_planes((e, d), 2, "matching (3, h, w) uint8 planes e and d")
    _, h2, w = e.shape
    if not _encode_planes("vkr_png_encode_planar_parity", path, (e, d), w, 2 * h2,
                          compression_level):
        woven = np.stack([e, d], axis=2).reshape(3, 2 * h2, w)
        write_png(path, np.moveaxis(woven, 0, -1), compression_level)


def write_png_planar_parity4(path: str, planes, compression_level: int = 6) -> None:
    """Encode from quad-parity planes (p00, p01, p10, p11), each (3, H/2,
    W/2) uint8, p[output row parity][output col parity].  The native codec
    weaves both axes inside its row loop; the zlib codec weaves on the host."""
    ps = _u8_planes(planes, 4, "4 matching (3, h, w) uint8 planes")
    _, h2, wh = ps[0].shape
    if not _encode_planes("vkr_png_encode_planar_parity4", path, ps, 2 * wh, 2 * h2,
                          compression_level):
        write_png(path, np.moveaxis(weave4_host(*ps), 0, -1), compression_level)


def write_png_planar_grid(path: str, planes, u: int, compression_level: int = 6) -> None:
    """Encode from grid-parity planes: u*u row-major (ry, rx) planes, each
    (3, H/u, W/u) uint8, output pixel (u*t+ry, u*s+rx) at plane (ry, rx)
    index (t, s).  The native codec weaves both axes inside its row loop;
    the zlib codec weaves on the host."""
    ps = _u8_planes(planes, u * u, f"{u * u} matching (3, h, w) uint8 planes")
    _, h, w = ps[0].shape
    lib = _native()
    if lib is None:
        write_png(path, np.moveaxis(weave_grid_host(ps, u), 0, -1), compression_level)
        return
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    ptrs = (u8p * len(ps))(*[p.ctypes.data_as(u8p) for p in ps])
    rc = lib.vkr_png_encode_planar_grid(os.fsencode(path), ptrs, u, u * w, u * h,
                                        compression_level)
    if rc != 0:
        raise OSError(_encode_err(rc, path))
