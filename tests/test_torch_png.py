"""The port's PNG reading and the CLI lines around it.

The stdlib zlib reader (the only codec on a machine without libpng) decodes
every PNG color type and bit depth, interlaced or not, to the pixels the
native libpng reader gives (palette lookup, 1/2/4-bit gray scaled to 0-255,
16-bit samples cut to their high byte, alpha and tRNS dropped): each format
is written here by hand with stdlib zlib, every PNG filter type on the way,
and both readers must return the encoded pixels exactly (the native one
where it builds).  A file that exists but does not decode gets its own
message from the CLI, not "Image not found".  The CLI prints the JAX CLI's
device-memory line."""
import os
import struct
import zlib

import numpy as np
import pytest

from vkresample_tpu_torch import Precision, UpscalePlan, cli
from vkresample_tpu_torch.io import png

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SAMPLE = os.path.join(ROOT, "samples", "test_256x128.png")
# (first row, first column, row step, column step) of the seven Adam7 passes
ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _scanlines(samples, depth):
    """(rows, width, channels) sample values -> (rows, stride) bytes as a
    PNG stores them: big-endian 16-bit samples, sub-byte samples packed from
    the most significant bit, each row padded to a whole byte."""
    n, w, ch = samples.shape
    flat = samples.reshape(n, w * ch).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], axis=-1).reshape(n, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(n, -1).astype(np.uint8), axis=1)


def _filtered(rows, bpp, first):
    """Scanlines with the filter types 0..4 in turn from `first`."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = (first + y) % 5
        out.append(ftype)
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((int(row[i]) - int(pred)) & 0xFF)
        prev = row
    return out


def _write_png(path, samples, depth, color, interlace=False, plte=None, trns=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    data = bytearray()
    for k, (y0, x0, dy, dx) in enumerate(ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        if sub.size:  # an empty pass has no scanlines
            data += _filtered(_scanlines(sub, depth), bpp, k)
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))]
    if plte is not None:
        chunks.append((b"PLTE", plte.astype(np.uint8).tobytes()))
    if trns is not None:
        chunks.append((b"tRNS", trns))
    chunks += [(b"IDAT", zlib.compress(bytes(data))), (b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(png._SIG + b"".join(png._chunk(kind, body) for kind, body in chunks))


def _expected_rgb(samples, depth, color, plte):
    """The 8-bit RGB pixels the readers should give."""
    if color == 3:
        return plte[samples[:, :, 0]].astype(np.uint8)
    s = samples >> 8 if depth == 16 else samples * (255 // ((1 << depth) - 1))
    s = s.astype(np.uint8)
    return np.repeat(s[:, :, :1], 3, axis=2) if color in (0, 4) else s[:, :, :3].copy()


CASES = (
    [(f"palette {d}-bit{' tRNS' if t else ''}", 3, d, False, (7, 13), t)
     for d in (1, 2, 4, 8) for t in (False, True)]
    + [(f"gray {d}-bit", 0, d, False, (7, 13), False) for d in (1, 2, 4, 16)]
    + [("gray+alpha 16-bit", 4, 16, False, (5, 6), False),
       ("RGB 16-bit", 2, 16, False, (5, 6), False),
       ("RGBA 16-bit", 6, 16, False, (5, 6), False)]
    + [(f"Adam7 RGB {d}-bit {h}x{w}", 2, d, True, (h, w), False)
       for d in (8, 16) for h, w in ((1, 1), (3, 5), (13, 17))]
    + [("Adam7 palette 4-bit 9x11", 3, 4, True, (9, 11), True),
       ("Adam7 gray 2-bit 9x11", 0, 2, True, (9, 11), False)]
)


@pytest.mark.parametrize("name,color,depth,interlace,hw,trns", CASES, ids=[c[0] for c in CASES])
def test_readers_decode_every_png_format(tmp_path, name, color, depth, interlace, hw, trns):
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w = hw
    top = 1 << depth
    plte = None
    if color == 3:
        n_entries = min(top, 200)  # an 8-bit palette need not have 256 entries
        plte = rng.integers(0, 256, (n_entries, 3))
        top = n_entries
    samples = rng.integers(0, top, (h, w, CHANNELS[color]))
    path = str(tmp_path / "f.png")
    _write_png(path, samples, depth, color, interlace, plte,
               bytes(rng.integers(0, 256, len(plte)).astype(np.uint8)) if trns else None)
    want = _expected_rgb(samples, depth, color, plte)
    got = png._zlib_read(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    if png._native() is not None:  # the native reader, where libpng builds
        np.testing.assert_array_equal(png.read_png(path), want)


@pytest.mark.parametrize("name,color,depth,interlace,hw,trns", CASES, ids=[c[0] for c in CASES])
def test_c_and_python_row_filters_decode_alike(tmp_path, monkeypatch, name, color, depth,
                                               interlace, hw, trns):
    """The zlib reader's two unfilters, the C one (io/native/unfilter.cpp)
    and the Python row loops taken where g++ is missing, decode every
    hand-written file, all five filter types in turn, to the same pixels."""
    if png._filters() is None:
        pytest.skip("g++ is missing: only the Python row loops exist here")
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    h, w = hw
    plte = rng.integers(0, 256, (200, 3)) if color == 3 else None
    top = 200 if color == 3 else 1 << depth
    samples = rng.integers(0, min(top, 1 << depth), (h, w, CHANNELS[color]))
    path = str(tmp_path / "f.png")
    _write_png(path, samples, depth, color, interlace, plte,
               bytes(rng.integers(0, 256, 8).astype(np.uint8)) if trns else None)
    want = _expected_rgb(samples, depth, color, plte)
    np.testing.assert_array_equal(png._zlib_read(path), want)  # the C unfilter
    monkeypatch.setattr(png, "_filters", lambda: None)
    np.testing.assert_array_equal(png._zlib_read(path), want)  # the Python loops


@pytest.mark.parametrize("has_gpp", [True, False])
def test_zlib_codec_line_names_its_row_filters(monkeypatch, capsys, has_gpp):
    """Without libpng the codec line says which unfilter the reader runs."""
    monkeypatch.setattr(png, "_codec", None)
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setattr(png, "_build_native", lambda: None)
    if not has_gpp:
        monkeypatch.setattr(png, "_filters", lambda: None)
    elif png._filters() is None:
        pytest.skip("g++ is missing here")
    capsys.readouterr()
    assert png._native() is None
    line = capsys.readouterr().out
    assert "PNG codec: stdlib zlib fallback" in line
    assert ("row filters in C" in line) == has_gpp
    assert ("row filters in Python (g++ unavailable)" in line) == (not has_gpp)


def _cli(capsys, *args):
    capsys.readouterr()
    rc = cli.main(list(args), device="cpu")
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("kind,msg", [("not a PNG", "not a PNG file"),
                                      ("truncated", "truncated PNG"),
                                      ("bad depth", "unsupported PNG")])
def test_undecodable_file_gets_its_own_message(tmp_path, capsys, kind, msg):
    """A file that exists but does not decode: read_png raises ValueError
    naming the fault (through either codec) and the CLI prints it and exits
    1; "Image not found" stays for a missing file."""
    path = tmp_path / "bad.png"
    if kind == "not a PNG":
        path.write_bytes(b"GIF89a" + bytes(100))
    elif kind == "truncated":
        data = open(SAMPLE, "rb").read()
        path.write_bytes(data[: len(data) // 2])
    else:
        _write_png(str(path), np.zeros((2, 2, 3), np.int64), 8, 2)
        data = bytearray(path.read_bytes())
        data[8 + 8 + 8] = 4  # IHDR bit depth 4: not allowed for RGB
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=msg):
        png.read_png(str(path))
    rc, out = _cli(capsys, "-i", str(path), "-o", str(tmp_path / "o.png"), "-u", "2")
    assert rc == 1 and msg in out and "Image not found" not in out, out
    assert not (tmp_path / "o.png").exists()
    rc, out = _cli(capsys, "-i", str(tmp_path / "missing.png"), "-u", "2")
    assert rc == 1 and "Image not found" in out


@pytest.mark.parametrize("args,kw", [
    (("-u", "2"), dict(upscale=2.0)),
    (("-u", "1.5"), dict(upscale=1.5)),
    (("-c2c", "-u", "2", "-p", "2"), dict(upscale=2.0, r2c=False, precision=2)),
])
def test_cli_prints_the_jax_memory_line(tmp_path, capsys, args, kw):
    """`HBM per device: N MB` after the plan, with the N of the JAX CLI's
    _hbm_estimate_mb for the same plan."""
    from vkresample_tpu.cli import _hbm_estimate_mb
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan

    rc, out = _cli(capsys, "-i", SAMPLE, "-o", str(tmp_path / "o.png"), *args)
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith("HBM per device: ")]
    jkw = dict(kw, precision=JPrecision(kw.get("precision", 0)))
    assert lines == [f"HBM per device: {_hbm_estimate_mb(JPlan(h=128, w=256, **jkw))} MB"]


@pytest.mark.parametrize("kw", [
    dict(h=1080, w=1920, upscale=2.0, precision=Precision.HALF),
    dict(h=1024, w=2048, upscale=2.0, precision=Precision.DOUBLE),
    dict(h=720, w=1280, upscale=3.0, r2c=False),
])
def test_memory_estimate_matches_jax(kw):
    from vkresample_tpu.cli import _hbm_estimate_mb
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan

    jkw = dict(kw, precision=JPrecision(int(kw["precision"]))) if "precision" in kw else kw
    want = _hbm_estimate_mb(JPlan(**jkw))
    assert want > 0 and cli._hbm_estimate_mb(UpscalePlan(**kw)) == want
