"""The port's u=2 routes end to end (CPU, plain versions) against the fp64
oracle, the JAX package's composed quad route and the golden sample; its
routing, CLI, PNG codecs and import hygiene.  The other factors and the
reference tier are in test_torch_routes.py; c2c in test_torch_c2c.py.
The CLI runs in-process with device="cpu" (the command line needs a CUDA
device)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale, cli, upscale
from vkresample_tpu_torch.fft import dense
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.cas_cuda import cas_parity_planes_u2_reference
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SAMPLES = os.path.join(ROOT, "samples")
SHAPES = [(64, 128), (128, 256)]
PRECS = [Precision.SINGLE, Precision.HALF]


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_slice_matches_oracle(h, w, prec):
    """Quad planes (the CLI call) and the woven library output within 1 LSB
    of the fp64 oracle, in SINGLE and HALF.  The woven output takes the
    rows route (as in the JAX package): it equals the rows-parity planes
    woven on the host."""
    img = _img(h, w, seed=h + w + int(prec))
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=prec)
    want = toracle.upscale_oracle(img, plan)
    planes = build_upscale(plan, "cpu", planes_out=True)(img)
    assert len(planes) == 4
    assert all(p.shape == (3, h, w) and p.dtype == torch.uint8 for p in planes)
    woven = png.weave4_host(*[p.numpy() for p in planes])
    assert _maxdiff(np.moveaxis(woven, 0, -1), want) <= 1
    out = upscale(img, 2.0, precision=prec, device="cpu")
    assert out.shape == (2 * h, 2 * w, 3) and out.dtype == torch.uint8
    assert _maxdiff(out.numpy(), want) <= 1
    codec = (dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
             if prec is Precision.HALF else {})
    banks = tpipe.make_device_banks(plan, Engine.MXU, "cpu", planes_out=False)
    U, O = dense.r2c_rows(torch.from_numpy(np.moveaxis(img, -1, 0).copy()), banks, **codec)
    E, D = cas_parity_planes_u2_reference(U, O, plan.sharpen)
    rows = np.stack([E.numpy(), D.numpy()], axis=2).reshape(3, 2 * h, 2 * w)
    np.testing.assert_array_equal(out.numpy(), np.moveaxis(rows, 0, -1))


@pytest.mark.parametrize("prec", PRECS)
def test_slice_matches_jax_quad_route(prec):
    """Against the JAX quad route composed by hand (make_dense_banks ->
    r2c_quad at HIGHEST [+ Q2.14 codec] -> K1 in interpret mode), the way
    the JAX package's own tests drive it on the CPU: within 1 LSB."""
    import jax
    import jax.numpy as jnp

    from vkresample_tpu.core.config import Engine as JEngine
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.fft import dense as jdense
    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.ops import cas as jcas
    from vkresample_tpu.ops.cas_pallas import cas_parity4_planes_u2 as jk1

    h, w = 64, 128
    img = _img(h, w, seed=31 + int(prec))
    jplan = JPlan(h=h, w=w, upscale=2.0, precision=JPrecision(int(prec)),
                  engine=JEngine.MXU)
    banks = mxu_pipeline.make_dense_banks(jplan)
    codec = (dict(store=jcas.to_i16_storage, load=jcas.from_i16_storage)
             if prec is Precision.HALF else {})
    Ps = jdense.r2c_quad(jnp.moveaxis(jnp.asarray(img), -1, 0), banks,
                         jax.lax.Precision.HIGHEST, **codec)
    want = jk1(*Ps, 0.2, block_rows=16, interpret=True)
    got = build_upscale(UpscalePlan(h=h, w=w, upscale=2.0, precision=prec),
                        "cpu", planes_out=True)(img)
    for a, b in zip(want, got):
        assert _maxdiff(a, b.numpy()) <= 1


def test_sample_matches_golden():
    img = png.read_png(os.path.join(SAMPLES, "test_256x128.png"))
    want = png.read_png(os.path.join(SAMPLES, "golden_256x128_x2.png"))
    for prec in PRECS:
        got = upscale(img, 2.0, precision=prec, device="cpu")
        assert got.shape == want.shape
        assert _maxdiff(got.numpy(), want) <= 1


def test_single_channel_and_plan_cache():
    img = _img(64, 128, seed=4, c=1)
    plan = UpscalePlan(h=64, w=128, upscale=2.0, channels=1)
    fn = build_upscale(plan, "cpu")
    assert build_upscale(plan, "cpu") is fn  # banks built once per plan
    out = fn(img[:, :, 0])
    assert out.shape == (128, 256, 1)
    assert _maxdiff(out.numpy(), toracle.upscale_oracle(img, plan)) <= 1
    with pytest.raises(ValueError, match="does not match plan"):
        fn(_img(64, 256, seed=0))
    with pytest.raises(TypeError, match="uint8"):
        fn(np.zeros((64, 128, 3), np.float32))


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(h=64, w=128, upscale=2.0, precision=Precision.DOUBLE), "item 2"),
        # ported since: they run, within 1 LSB of the oracle
        (dict(h=64, w=128, upscale=2.0, r2c=False), "grid"),
        (dict(h=64, w=128, upscale=3.0), None),
        (dict(h=64, w=128, upscale=1.0), None),
        (dict(h=64, w=128, upscale=1.5), None),
        (dict(h=64, w=96, upscale=2.0), "rows"),
        (dict(h=64, w=8192, upscale=2.0), "item 5"),
    ],
)
def test_out_of_slice_plans_raise(kw, item):
    """fp64 and axes over the dense cap raise naming their ROADMAP.md item;
    the other plans run (item = their planes_format)."""
    plan = UpscalePlan(**kw)
    if item in (None, "rows", "grid"):
        assert tpipe.planes_format(plan) == item
        img = _img(plan.h, plan.w, seed=plan.w + plan.H)
        got = build_upscale(plan, "cpu")(img)
        assert _maxdiff(got.numpy(), toracle.upscale_oracle(img, plan)) <= 1
        return
    assert tpipe.planes_format(plan) is None
    assert not tpipe.parity_planes_supported(plan)
    with pytest.raises(NotImplementedError, match=item):
        build_upscale(plan, "cpu")


def test_routing_matches_jax_parity_route():
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.pipeline.upscale import _parity_route as jroute

    for h, w, u in [(64, 128, 2.0), (64, 96, 2.0), (64, 128, 3.0), (4096, 4100, 2.0),
                    (64, 128, 1.5)]:
        assert tpipe._parity_route(UpscalePlan(h=h, w=w, upscale=u)) == jroute(
            JPlan(h=h, w=w, upscale=u))
    assert tpipe.planes_format(UpscalePlan(h=64, w=128, upscale=2.0)) == "quad"


def _cli(capsys, *args):
    """The CLI in-process on the CPU: (exit code, stdout)."""
    capsys.readouterr()
    rc = cli.main(list(args), device="cpu")
    return rc, capsys.readouterr().out


def test_cli_validate_and_golden(tmp_path, capsys):
    out = str(tmp_path / "out.png")
    rc, stdout = _cli(capsys, "-i", os.path.join(SAMPLES, "test_256x128.png"), "-o", out,
                      "-u", "2", "-p", "2", "-n", "2", "-validate")
    assert rc == 0, stdout
    assert "Validation vs fp64 oracle: maxdiff=" in stdout
    assert "upscale: 256x128 to 512x256 Time: " in stdout
    gold = png.read_png(os.path.join(SAMPLES, "golden_256x128_x2.png"))
    assert _maxdiff(png.read_png(out), gold) <= 1


@pytest.mark.parametrize(
    "args,rc,msg",
    [
        # -u 1.5 and -c2c are ported since: they run and validate
        (("-u", "1.5", "-validate"), 0, "maxdiff="),
        (("-u", "2", "-p", "1"), 1, "not ported yet (ROADMAP.md modules item 2)"),
        (("-u", "2", "-c2c", "-validate"), 0, "(tol 1) OK"),
        (("-ifolder", "x", "-u", "2"), 1, "not ported yet"),
        (("-u", "2", "-engine"), 1, "No engine"),
        (("-p",), 1, "No precision"),
    ],
)
def test_cli_errors_exit_1(tmp_path, capsys, args, rc, msg):
    """Plans and flags outside the port exit 1 with a message and write no
    file; the missing input and -h cases ride on the running cases."""
    sample = os.path.join(SAMPLES, "test_256x128.png")
    out = tmp_path / "a.png"
    full = args if args[0] == "-ifolder" else ("-i", sample, "-o", str(out)) + args
    got_rc, stdout = _cli(capsys, *full)
    assert got_rc == rc, (args, stdout)
    assert msg in stdout, (args, stdout)
    assert out.exists() == (rc == 0)
    if rc == 0:
        got_rc, stdout = _cli(capsys, "-i", str(tmp_path / "missing.png"), "-u", "2")
        assert got_rc == 1 and "Image not found" in stdout
        got_rc, stdout = _cli(capsys, "-h")
        assert got_rc == 0 and all(f in stdout for f in ("-validate", "-engine", "-c2c"))


def test_command_line_needs_a_cuda_device(monkeypatch, capsys):
    """Without a CUDA device the command line (main() without a device)
    exits 1 with a message; it never runs on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["-i", os.path.join(SAMPLES, "test_256x128.png"), "-u", "2"])
    assert rc == 1 and "Error: no CUDA device" in capsys.readouterr().out


def test_entry_points_need_a_cuda_device_unless_cpu_is_asked(monkeypatch):
    """build_upscale, upscale and banks_from_jax run on the card by
    default and raise without one; device="cpu" is the only way to the
    CPU."""
    from vkresample_tpu_torch.weights import banks_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = UpscalePlan(h=64, w=128, upscale=2.0)
    img = _img(64, 128, seed=3)
    for call in (lambda: build_upscale(plan), lambda: upscale(img, 2.0),
                 lambda: banks_from_jax({"alpha": np.zeros((2, 2))})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert build_upscale(plan, "cpu")(img).device.type == "cpu"
    assert banks_from_jax({"alpha": np.zeros((2, 2))}, "cpu")["alpha"].device.type == "cpu"


def test_png_codec_builds_the_ports_own_source():
    """io/png.py compiles the port's copy of pngio.cpp (never a file of the
    JAX package) into the port's build directory."""
    pkg = os.path.realpath(os.path.join(ROOT, "vkresample_tpu_torch"))
    src = os.path.realpath(png._PNGIO_SRC)
    assert src.startswith(pkg + os.sep) and os.path.isfile(src)
    assert os.path.realpath(png._BUILD_DIR).startswith(pkg + os.sep)
    with open(src) as f:
        assert "vkr_png_encode_planar_grid" in f.read()
    built = png._build_native()
    assert built is None or os.path.realpath(built).startswith(pkg + os.sep)


def test_slice_runs_without_jax():
    """The package imports and runs with jax and the JAX package absent
    (the card machine has no jax)."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['vkresample_tpu'] = None\n"
        "import numpy as np, vkresample_tpu_torch as v\n"
        "from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle\n"
        "img = np.random.default_rng(0).integers(0, 256, (64, 128, 3), np.uint8)\n"
        "for r2c in (True, False):\n"
        "    p = v.UpscalePlan(h=64, w=128, upscale=2.0, precision=v.Precision.HALF, r2c=r2c)\n"
        "    out = v.upscale(img, 2.0, plan=p, device='cpu').numpy()\n"
        "    d = np.abs(out.astype(int) - upscale_oracle(img, p)).max()\n"
        "    assert d <= 1, d\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'vkresample_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_import_builds_nothing_and_skips_triton():
    """Importing every module of the package starts no compiler, loads no
    shared library and imports no triton: kernels build at first launch."""
    code = (
        "import ctypes, pkgutil, importlib, subprocess, sys\n"
        "import numpy, torch  # their own shared libraries load here\n"
        "def _no(*a, **k): raise AssertionError('build or load at import')\n"
        "subprocess.Popen = _no; ctypes.CDLL = _no\n"
        "import vkresample_tpu_torch as v\n"
        "for m in pkgutil.walk_packages(v.__path__, 'vkresample_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "assert 'triton' not in sys.modules\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_no_port_module_imports_jax():
    pkg = os.path.join(ROOT, "vkresample_tpu_torch")
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "build"]  # build outputs
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "import vkresample_tpu\n",
                            "from vkresample_tpu ", "from vkresample_tpu.",
                            "import vkresample_tpu."):
                    assert bad not in src, (f, bad)


def test_zlib_codec_roundtrip_and_agrees_with_native(tmp_path):
    """The stdlib zlib codec reads the samples (Sub filters) and its own
    output, and writes what the reader (either codec) decodes back."""
    img = png.read_png(os.path.join(SAMPLES, "test_256x128.png"))
    np.testing.assert_array_equal(png._zlib_read(os.path.join(SAMPLES, "test_256x128.png")), img)
    path = str(tmp_path / "z.png")
    png._zlib_write(path, img, 6)
    np.testing.assert_array_equal(png._zlib_read(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_zlib_reader_unfilters_all_filter_types(tmp_path):
    """Rows encoded with each PNG filter (None, Sub, Up, Average, Paeth)
    decode to the original pixels; gray input expands to RGB."""
    import struct
    import zlib

    rng = np.random.default_rng(2)
    h, w, bpp = 5, 7, 3
    img = rng.integers(0, 256, (h, w * bpp)).astype(np.int32)

    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)

    raw = bytearray()
    for y in range(h):
        ftype = y % 5
        raw.append(ftype)
        for i in range(w * bpp):
            a = img[y, i - bpp] if i >= bpp else 0
            b = img[y - 1, i] if y else 0
            c = img[y - 1, i - bpp] if (y and i >= bpp) else 0
            pred = [0, a, b, (a + b) // 2, paeth(a, b, c)][ftype]
            raw.append((int(img[y, i]) - pred) & 0xFF)

    def write(path, color, data, width):
        ihdr = struct.pack(">IIBBBBB", width, h, 8, color, 0, 0, 0)
        with open(path, "wb") as f:
            f.write(png._SIG + png._chunk(b"IHDR", ihdr)
                    + png._chunk(b"IDAT", zlib.compress(bytes(data)))
                    + png._chunk(b"IEND", b""))

    path = str(tmp_path / "f.png")
    write(path, 2, raw, w)
    np.testing.assert_array_equal(png._zlib_read(path), img.reshape(h, w, 3))
    gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
    graw = b"".join(b"\x00" + gray[y].tobytes() for y in range(h))
    write(path, 0, graw, w)
    np.testing.assert_array_equal(png._zlib_read(path), np.repeat(gray[:, :, None], 3, 2))


def test_time_amortized_on_cpu():
    from vkresample_tpu_torch.pipeline.timing import time_amortized

    calls = []
    out, ms = time_amortized(lambda x: calls.append(x) or x, (3,), 4, "cpu")
    assert out == 3 and len(calls) == 5 and ms >= 0.0
