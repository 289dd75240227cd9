"""The port's batched-folder mode on the CPU: the frame naming protocol
(io/folder.py), the PNG worker pool (io/png.py PngPool) on both codecs
(native libpng where it builds, and the stdlib zlib codec the card machine
has, forced here by taking the native one away), and the folder CLI run
in-process with device="cpu" (the kernels' plain versions), as
tests/test_cli.py drives the JAX CLI's folder mode."""
import numpy as np
import pytest

from vkresample_tpu import cli as jcli
from vkresample_tpu.io.folder import frame_paths as jframe_paths
from vkresample_tpu_torch import UpscalePlan, cli
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.io.folder import frame_path, frame_paths
from vkresample_tpu_torch.oracle import numpy_ref as toracle

N = 3


@pytest.fixture(params=["native", "zlib"])
def codec(request, monkeypatch):
    """The codec PngPool and the single-frame readers and writers use."""
    if request.param == "zlib":
        monkeypatch.setattr(png, "_native", lambda: None)
    elif png._native() is None:
        pytest.skip("libpng does not build here: the native codec is absent")
    return request.param


def _rng_u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_frame_paths_match_jax():
    for prefix, n in (("inp", 3), ("out/img", 12), ("a b", 1), ("x", 0)):
        assert frame_paths(prefix, n) == jframe_paths(prefix, n)
    assert frame_path("inp/img", 7) == "inp/img/000007.png"


# encoder -> (the pool call on the frames (N, h, w, 3) cut to the encoder's
# planes, the single-frame writer of frame i cut the same way)
ENCODERS = {
    "encode_batch": (lambda pool, paths, f: pool.encode_batch(paths, f),
                     lambda path, f, i: png.write_png(path, f[i])),
    "planar": (lambda pool, paths, f: pool.encode_batch_planar(paths, np.moveaxis(f, -1, 1)),
               lambda path, f, i: png.write_png_planar(path, np.moveaxis(f[i], -1, 0))),
    "parity": (lambda pool, paths, f: pool.encode_batch_planar_parity(
                   paths, *[np.moveaxis(f, -1, 1)[:, :, r::2] for r in (0, 1)]),
               lambda path, f, i: png.write_png_planar_parity(
                   path, *[np.moveaxis(f[i], -1, 0)[:, r::2] for r in (0, 1)])),
    "parity4": (lambda pool, paths, f: pool.encode_batch_planar_parity4(
                    paths, [np.moveaxis(f, -1, 1)[:, :, r::2, s::2] for r in (0, 1)
                            for s in (0, 1)]),
                lambda path, f, i: png.write_png_planar_parity4(
                    path, [np.moveaxis(f[i], -1, 0)[:, r::2, s::2] for r in (0, 1)
                           for s in (0, 1)])),
    "grid u=3": (lambda pool, paths, f: pool.encode_batch_planar_grid(
                     paths, [np.moveaxis(f, -1, 1)[:, :, r::3, s::3] for r in range(3)
                             for s in range(3)], 3),
                 lambda path, f, i: png.write_png_planar_grid(
                     path, [np.moveaxis(f[i], -1, 0)[:, r::3, s::3] for r in range(3)
                            for s in range(3)], 3)),
}


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_pool_encoders_write_what_the_single_frame_writers_write(tmp_path, codec, encoder):
    """Each batch encoder (native pool entry, or the zlib executor) writes
    the very bytes of its single-frame writer, and the frames read back."""
    frames = _rng_u8((N, 12, 18, 3), seed=len(encoder))
    pool_call, single = ENCODERS[encoder]
    paths = [str(tmp_path / f"b{i}.png") for i in range(N)]
    with png.PngPool(2) as pool:
        pool_call(pool, paths, frames)
    for i, path in enumerate(paths):
        one = str(tmp_path / f"s{i}.png")
        single(one, frames, i)
        with open(path, "rb") as a, open(one, "rb") as b:
            assert a.read() == b.read(), (encoder, i)
        np.testing.assert_array_equal(png.read_png(path), frames[i])


def test_pool_decode_batch_matches_read_png(tmp_path, codec):
    frames = _rng_u8((5, 9, 14, 3), seed=3)
    paths = [str(tmp_path / f"{i}.png") for i in range(5)]
    for path, f in zip(paths, frames):
        png.write_png(path, f)
    with png.PngPool(3) as pool:
        got = pool.decode_batch(paths, 14, 9)
    assert got.shape == (5, 9, 14, 3) and got.dtype == np.uint8
    for path, g in zip(paths, got):
        np.testing.assert_array_equal(g, png.read_png(path))
    np.testing.assert_array_equal(got, frames)


def test_pool_decode_faults(tmp_path, codec):
    """A missing frame raises FileNotFoundError, a frame of another size the
    size-mismatch ValueError, a file that is no PNG a ValueError."""
    good = str(tmp_path / "good.png")
    png.write_png(good, _rng_u8((6, 8, 3), seed=4))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with png.PngPool(2) as pool:
        with pytest.raises(FileNotFoundError):
            pool.decode_batch([good, str(tmp_path / "missing.png")], 8, 6)
        with pytest.raises(ValueError, match="size mismatch"):
            pool.decode_batch([good], 9, 6)
        with pytest.raises(ValueError):
            pool.decode_batch([good, str(bad)], 8, 6)


def test_pool_encoders_check_their_planes(tmp_path, codec):
    planes = [np.zeros((2, 3, 4, 4), np.uint8)] * 4
    with png.PngPool(1) as pool:
        with pytest.raises(ValueError):
            pool.encode_batch_planar_parity4([str(tmp_path / "a.png")], planes)  # 1 path, N = 2
        with pytest.raises(ValueError):
            pool.encode_batch_planar_grid([str(tmp_path / f"{i}.png") for i in range(2)],
                                          planes, 3)  # 4 planes for u = 3


def _cli(capsys, *args):
    capsys.readouterr()
    rc = cli.main(list(args), device="cpu")
    return rc, capsys.readouterr().out


# folder run -> (h, w, flags): the quad route (128-aligned width), the rows
# route, the c2c grid (grid planes) and u=3 (woven planar frames)
FOLDER_RUNS = {
    "quad": (16, 128, ["-u", "2", "-p", "2"]),
    "rows": (24, 96, ["-u", "2"]),
    "c2c grid": (32, 32, ["-c2c", "-u", "2", "-p", "2"]),
    "u=3 woven": (16, 32, ["-u", "3"]),
}


@pytest.mark.parametrize("run", list(FOLDER_RUNS))
def test_folder_cli_matches_oracle(tmp_path, capsys, codec, run):
    """5 frames, -batch 2 (a tail of 1), -numthreads 2: every output within
    1 LSB of the fp64 oracle; the frames/s and device lines printed."""
    h, w, flags = FOLDER_RUNS[run]
    n = 5
    inp, outp = tmp_path / "inp", tmp_path / "outp"
    inp.mkdir()
    outp.mkdir()
    frames = _rng_u8((n, h, w, 3), seed=h + w)
    for path, f in zip(frame_paths(str(inp), n), frames):
        png.write_png(path, f)
    rc, out = _cli(capsys, "-ifolder", str(inp), "-ofolder", str(outp), "-numfiles", str(n),
                   "-numthreads", "2", "-batch", "2", *flags)
    assert rc == 0, out
    assert "Upscaled 5 frames" in out and "frames/s" in out, out
    assert "Finished. Device name: cpu" in out and "(1 device(s))" in out, out
    assert "HBM per device:" in out
    u = float(flags[flags.index("-u") + 1])
    plan = UpscalePlan(h=h, w=w, upscale=u, r2c="-c2c" not in flags)
    for path, f in zip(frame_paths(str(outp), n), frames):
        got = png.read_png(path)
        want = toracle.upscale_oracle(f, plan)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, path


def test_folder_cli_resume_leaves_existing_outputs(tmp_path, capsys):
    """-resume skips frames whose output exists and leaves those files as
    they were (tests/test_cli.py::test_batched_resume_skips_existing)."""
    n = 4
    inp, outp = tmp_path / "rin", tmp_path / "rout"
    inp.mkdir()
    outp.mkdir()
    for i, path in enumerate(frame_paths(str(inp), n)):
        png.write_png(path, _rng_u8((16, 32, 3), seed=i))
    marker = _rng_u8((32, 64, 3), seed=99)
    for i in (1, 3):
        png.write_png(frame_path(str(outp), i), marker)
    args = ("-ifolder", str(inp), "-ofolder", str(outp), "-numfiles", str(n), "-u", "2",
            "-resume")
    rc, out = _cli(capsys, *args)
    assert rc == 0 and "Resume: skipping 2 already-upscaled frames" in out, out
    np.testing.assert_array_equal(png.read_png(frame_path(str(outp), 1)), marker)
    np.testing.assert_array_equal(png.read_png(frame_path(str(outp), 3)), marker)
    for i in (2, 4):
        assert png.read_png(frame_path(str(outp), i)).shape == (32, 64, 3)
    rc, out = _cli(capsys, *args)
    assert rc == 0 and "skipping 4" in out and "Resume: nothing to do" in out, out


def test_folder_cli_missing_frames_exit_1(tmp_path, capsys):
    """No first frame: "Image not found"; a later frame missing: a clean
    error naming it, exit 1."""
    inp = tmp_path / "m"
    inp.mkdir()
    rc, out = _cli(capsys, "-ifolder", str(inp), "-numfiles", "2", "-u", "2")
    assert rc == 1 and "Image not found" in out
    png.write_png(frame_path(str(inp), 1), _rng_u8((16, 32, 3), seed=1))
    rc, out = _cli(capsys, "-ifolder", str(inp), "-ofolder", str(tmp_path), "-numfiles", "2",
                   "-u", "2")
    assert rc == 1 and "Image not found" in out and "000002.png" in out, out


@pytest.mark.parametrize("flags,msg", [(("-numfiles", "0"), "-numfiles takes a positive"),
                                       (("-numfiles", "1", "-batch", "-2"),
                                        "-batch takes a positive")])
def test_folder_cli_counts_must_be_positive(tmp_path, capsys, flags, msg):
    png.write_png(frame_path(str(tmp_path), 1), _rng_u8((16, 32, 3), seed=2))
    rc, out = _cli(capsys, "-ifolder", str(tmp_path), "-u", "2", *flags)
    assert rc == 1 and msg in out, out


PARSES = [
    ("-ifolder", "inp/img", "-ofolder", "out/img", "-numfiles", "24", "-numthreads", "8",
     "-u", "2", "-p", "2", "-batch", "4", "-resume"),
    ("-ifolder", "inp", "-u", "1.5", "-c2c", "-s", "0.1"),
    ("-ifolder", "inp", "-numfiles", "3", "-i", "ignored.png", "-o", "ignored.png"),
    ("-ifolder",),
    ("-ifolder", "inp", "-numfiles"),
    ("-ifolder", "inp", "-u", "2", "-numthreads"),
    ("-ifolder", "inp", "-u", "2", "-ofolder"),
]


@pytest.mark.parametrize("argv", PARSES, ids=[" ".join(a) for a in PARSES])
def test_folder_flags_parse_as_in_jax(capsys, argv):
    """The folder flags give the JAX CLI's configuration, extras and
    messages."""
    capsys.readouterr()
    got = cli._parse(list(argv))
    got_out = capsys.readouterr().out
    want = jcli._parse(list(argv))
    assert got_out == capsys.readouterr().out
    assert (got is None) == (want is None)
    if got is None:
        return
    for key in ("upscale", "num_threads", "num_files", "sharpen", "ifolder_prefix",
                "ofolder_prefix", "input_path", "output_path", "file_upload"):
        assert getattr(got[0], key) == getattr(want[0], key), key
    assert int(got[0].precision) == int(want[0].precision)
    for key in ("c2c", "batch", "resume"):
        assert got[1][key] == want[1][key], key


def test_help_lists_the_folder_flags(capsys):
    rc, out = _cli(capsys, "-h")
    assert rc == 0 and "Batched mode:" in out
    for flag in ("-ifolder", "-ofolder", "-numfiles", "-numthreads", "-batch", "-resume"):
        assert flag in out
    assert "not ported" not in out.split("Batched mode:")[1]
