"""The port's batched upscale (vkresample_tpu_torch/pipeline/batched.py) on
the CPU, with the kernels' plain versions: N = 3 seeded frames through
build_batched_upscale on every route, -p 0 and -p 2, each frame within
1 LSB of the JAX package's batched output (build_batched_upscale run on
the CPU as tests/test_batched.py runs it: its woven planar output, since
the JAX package has parity planes only with its TPU kernels), of the fp64
oracle and of the port's single-frame build_upscale."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from vkresample_tpu.core.config import Engine as JEngine
from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.core.plan import UpscalePlan as JPlan
from vkresample_tpu.pipeline.batched import build_batched_upscale as jbuild_batched
from vkresample_tpu_torch import (Engine, Precision, UpscalePlan, build_batched_upscale,
                                  build_upscale, upscale_batch)
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline.upscale import MAX_PLANES, planes_format

N = 3
# route -> (h, w, u, r2c, engine, the port's parity-plane format)
ROUTES = {
    "quad": (16, 128, 2.0, True, "AUTO", "quad"),
    "rows u=2": (24, 96, 2.0, True, "AUTO", "rows"),
    "rows u=3": (16, 32, 3.0, True, "AUTO", None),
    "chain 1.5x": (16, 32, 1.5, True, "AUTO", None),
    "c2c grid u=2": (32, 32, 2.0, False, "AUTO", "grid"),
    "c2c grid u=3": (32, 32, 3.0, False, "AUTO", "grid"),
    "c2c chain 2.5x": (16, 32, 2.5, False, "AUTO", None),
    "xla": (16, 32, 2.0, True, "XLA", None),
}
PRECS = [Precision.SINGLE, Precision.HALF]


def _frames(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (N, h, w, 3), np.uint8)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _woven(out, fmt, plan):
    """A batch's output (parity planes of `fmt`, or planar frames when fmt
    is None) as (N, H, W, C) uint8 host frames."""
    if fmt is None:
        return np.moveaxis(out.numpy(), 1, -1)
    planes = [p.numpy() for p in out]
    if fmt == "quad":
        woven = png.weave4_host(*planes)
    elif fmt == "grid":
        woven = png.weave_grid_host(planes, int(round(len(planes) ** 0.5)))
    else:
        woven = np.stack(planes, axis=3).reshape(len(planes[0]), 3, plan.H, plan.W)
    return np.moveaxis(woven, 1, -1)


def _plane_shapes(fmt, plan):
    """The batched planes' shapes: 2 x (N, C, H/2, W) rows, p^2 x (N, C,
    H/p, W/p) quad (p = 2) or grid, one (N, C, H, W) planar image."""
    if fmt == "rows":
        return [(N, 3, plan.H // 2, plan.W)] * 2
    p = {"quad": 2, "grid": Fraction(plan.H, plan.h).numerator, None: 1}[fmt]
    return [(N, 3, plan.H // p, plan.W // p)] * (p * p)


@pytest.mark.parametrize("prec", PRECS, ids=lambda p: p.name)
@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_route_matches_jax_oracle_and_single_frame(route, prec):
    h, w, u, r2c, engine, fmt = ROUTES[route]
    plan = UpscalePlan(h=h, w=w, upscale=u, precision=prec, r2c=r2c, engine=Engine[engine])
    assert planes_format(plan) == fmt
    frames = _frames(h, w, seed=h * w + int(10 * u) + int(prec))
    jplan = JPlan(h=h, w=w, upscale=u, precision=JPrecision(int(prec)), r2c=r2c,
                  engine=JEngine[engine])
    jax_out = np.moveaxis(np.asarray(jbuild_batched(jplan, None, planar_out=True)(frames)), 1, -1)
    want = [toracle.upscale_oracle(f, plan) for f in frames]
    outs = {"woven": (build_batched_upscale(plan, "cpu")(frames), "hwc")}
    outs["planar"] = (build_batched_upscale(plan, "cpu", planar_out=True)(frames), None)
    if fmt is not None:
        outs["planes"] = (build_batched_upscale(plan, "cpu", planar_out=True,
                                                planes_out=True)(frames), fmt)
    for form, (out, layout) in outs.items():
        if layout == "hwc":
            assert out.shape == (N, plan.H, plan.W, 3) and out.dtype == torch.uint8
            got = out.numpy()
        else:
            shapes = [tuple(p.shape) for p in (out if layout else [out])]
            assert shapes == _plane_shapes(layout, plan), (form, shapes)
            got = _woven(out, layout, plan)
        single = build_upscale(plan, "cpu", planes_out=form == "planes",
                               planar_out=form != "woven")
        for i in range(N):
            assert _maxdiff(got[i], want[i]) <= 1, (form, i, "oracle")
            assert _maxdiff(got[i], jax_out[i]) <= 1, (form, i, "JAX batched")
            one = single(frames[i])
            one = one.numpy() if layout == "hwc" else _woven(
                tuple(p[None] for p in one) if layout else one[None], layout, plan)[0]
            assert _maxdiff(got[i], one) <= 1, (form, i, "single frame")


def test_upscale_batch_takes_4d_uint8_only():
    """As the JAX upscale_batch: TypeError on float frames and on a single
    frame; a batch of one is a batch."""
    plan = UpscalePlan(h=16, w=32, upscale=2.0)
    with pytest.raises(TypeError):
        upscale_batch(np.zeros((2, 16, 32, 3), np.float32), plan, device="cpu")
    with pytest.raises(TypeError):
        upscale_batch(np.zeros((16, 32, 3), np.uint8), plan, device="cpu")
    frames = _frames(16, 32, seed=5)[:1]
    out = upscale_batch(frames, plan, device="cpu")
    assert out.shape == (1, 32, 64, 3)
    assert _maxdiff(out[0].numpy(), toracle.upscale_oracle(frames[0], plan)) <= 1


def test_batched_builds_are_cached_per_plan_device_and_flags():
    plan = UpscalePlan(h=16, w=32, upscale=2.0)
    fn = build_batched_upscale(plan, "cpu", planar_out=True)
    assert build_batched_upscale(plan, torch.device("cpu"), planar_out=True) is fn
    assert build_batched_upscale(plan, "cpu") is not fn


def test_batch_over_the_kernels_plane_limit_raises():
    """Frames x channels ride on the CAS kernels' grid.z: past MAX_PLANES a
    clear ValueError, before any work."""
    plan = UpscalePlan(h=8, w=8, upscale=2.0)
    frames = torch.zeros((MAX_PLANES // 3 + 1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="planes"):
        build_batched_upscale(plan, "cpu")(frames)


def test_batched_rejects_a_frame_size_off_the_plan():
    plan = UpscalePlan(h=16, w=32, upscale=2.0)
    with pytest.raises(ValueError, match="does not match plan"):
        build_batched_upscale(plan, "cpu")(np.zeros((2, 16, 30, 3), np.uint8))
