"""The port's "dp" mode on the CPU (vkresample_tpu_torch/parallel/mesh.py,
pipeline/batched.py with a list of devices): a batch split over
["cpu", "cpu"] equals the one-device batch on every pixel, on the quad,
rows and grid routes; the even split's errors; the folder CLI's batch
rounding against the JAX CLI's (vkresample_tpu/cli.py:324-332), and a
folder run over two devices; the -devices printer."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch import (Engine, Precision, UpscalePlan, build_batched_upscale, cli,
                                  upscale_batch)
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.io.folder import frame_paths
from vkresample_tpu_torch.parallel import mesh
from vkresample_tpu_torch.pipeline.upscale import planes_format

N = 4
# route -> (h, w, u, r2c, precision); the port's parity-plane format of each
# is planes_format(plan)
ROUTES = {
    "quad": (16, 128, 2.0, True, Precision.HALF),
    "rows": (24, 96, 2.0, True, Precision.SINGLE),
    "rows u=3": (16, 32, 3.0, True, Precision.HALF),
    "c2c grid u=3": (32, 32, 3.0, False, Precision.HALF),
}


def _frames(h, w, seed, n=N):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


def _plan(route):
    h, w, u, r2c, prec = ROUTES[route]
    return UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=prec, engine=Engine.AUTO)


# woven output on every route, parity planes where the route has them
DP_RUNS = [(route, planes_out) for route in ROUTES for planes_out in (False, True)
           if not planes_out or planes_format(_plan(route)) is not None]


@pytest.mark.parametrize("route,planes_out", DP_RUNS,
                         ids=[f"{r} {'planes' if p else 'woven'}" for r, p in DP_RUNS])
def test_dp_batch_equals_one_device_batch(route, planes_out):
    """N = 4 frames over ["cpu", "cpu"]: two outputs of 2 frames each, in
    frame order, equal to the one-device batch on every pixel."""
    plan = _plan(route)
    frames = torch.from_numpy(_frames(plan.h, plan.w, seed=len(route)))
    one = build_batched_upscale(plan, "cpu", planes_out=planes_out)(frames)
    two = build_batched_upscale(plan, ["cpu", "cpu"], planes_out=planes_out)(frames)
    assert isinstance(two, list) and len(two) == 2
    if planes_out:
        for i, plane in enumerate(one):
            assert all(part[i].shape[0] == N // 2 for part in two)
            assert torch.equal(torch.cat([part[i] for part in two]), plane), i
    else:
        assert torch.equal(torch.cat(two), one)


def test_upscale_batch_over_devices():
    plan = _plan("rows")
    frames = _frames(plan.h, plan.w, seed=5)
    parts = upscale_batch(frames, plan, device=("cpu", "cpu"))
    assert [tuple(p.shape) for p in parts] == [(N // 2, plan.H, plan.W, 3)] * 2
    assert torch.equal(torch.cat(parts), upscale_batch(frames, plan, device="cpu"))


def test_split_frames_is_even_or_raises():
    assert mesh.split_frames(6, ["cpu"] * 3) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    assert mesh.split_frames(0, ["cpu"] * 2) == [slice(0, 0), slice(0, 0)]
    with pytest.raises(ValueError, match="do not split evenly over 2 devices"):
        mesh.split_frames(3, ["cpu", "cpu"])
    plan = _plan("rows")
    with pytest.raises(ValueError, match="do not split evenly"):
        build_batched_upscale(plan, ["cpu", "cpu"])(torch.from_numpy(_frames(plan.h, plan.w, 1, 3)))


def test_data_parallel_devices():
    assert mesh.data_parallel_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one device"):
        mesh.data_parallel_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.data_parallel_devices()


def _jax_cli_batch(requested, n_files, n_dev):
    """vkresample_tpu/cli.py:324-332 as written there."""
    batch = requested or max(n_dev, min(8, n_files))
    if n_dev > 1:
        batch = max(n_dev, (batch // n_dev) * n_dev)
    return batch


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_batch_rounding_matches_the_jax_cli(n_dev):
    for requested in (0, 1, 2, 3, 5, 8, 9, 16):
        for n_files in (1, 2, 3, 7, 8, 24):
            assert mesh.batch_for_devices(requested, n_files, n_dev) == \
                _jax_cli_batch(requested, n_files, n_dev), (requested, n_files)
    assert mesh.batch_for_devices(0, 24, 1) == 8
    assert mesh.batch_for_devices(5, 24, 2) == 4
    assert mesh.batch_for_devices(0, 3, 4) == 4


@pytest.mark.parametrize("flags", [["-u", "2", "-p", "2"], ["-c2c", "-u", "3", "-p", "2"]],
                         ids=["quad", "c2c grid"])
def test_folder_cli_over_two_devices(tmp_path, capsys, flags):
    """The folder CLI given two devices: 5 frames at -batch 3 run as
    batches of 2, 2 and a tail of 1 padded to 2; every output equals the
    one-device run's, and the completion line counts 2 devices."""
    n, h, w = 5, 16, 128
    inp, one, two = (tmp_path / d for d in ("inp", "one", "two"))
    for d in (inp, one, two):
        d.mkdir()
    for path, f in zip(frame_paths(str(inp), n), _frames(h, w, seed=9, n=n)):
        png.write_png(path, f)
    base = ["-ifolder", str(inp), "-numfiles", str(n), "-batch", "3", *flags]
    assert cli.main(base + ["-ofolder", str(one)], device="cpu") == 0
    capsys.readouterr()
    assert cli.main(base + ["-ofolder", str(two)], device=["cpu", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Upscaled 5 frames" in out and "(2 device(s))" in out, out
    for a, b in zip(frame_paths(str(one), n), frame_paths(str(two), n)):
        np.testing.assert_array_equal(png.read_png(b), png.read_png(a))


def test_device_list_printer(monkeypatch, capsys):
    """-devices prints parallel/mesh.py::device_list_string: 'No CUDA
    devices found.' without a card, else one 'Device id: N name: X' line
    per card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.device_list_string() == "No CUDA devices found."
    assert cli.main(["-devices"]) == 0
    assert capsys.readouterr().out == "No CUDA devices found.\n"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"Card {i}")
    want = "Device id: 0 name: Card 0\nDevice id: 1 name: Card 1"
    assert mesh.device_list_string() == want
    assert cli.main(["-devices"]) == 0
    assert capsys.readouterr().out == want + "\n"
