"""The port's big tiers (every axis beyond the 8192 dense cap) on the CPU,
plain versions of K1, K3 and K4: the staged quad, the r2c big grid (u >= 3
and p/q), the c2c grid above the cap and the reference tier, end to end
against the fp64 oracle and the JAX package's _pipeline at the same plan;
then over the real cap at thin shapes; the channel-serial loop and the CLI.

The cap is lowered (core/plan.py DENSE_MAX, and the JAX package's
fft/mxu_pipeline.py DENSE_MAX beside it) to run the big routes at small
shapes, as JAX's tests/test_staged.py does.

Tolerances: uint8 images <= 1 LSB (the JAX package's own bar against the
oracle and between its routes)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkresample_tpu.core.config import Engine as JEngine
from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.core.plan import UpscalePlan as JPlan
from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale, cli
from vkresample_tpu_torch.core import plan as plan_mod
from vkresample_tpu_torch.fft import mxu_pipeline
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SAMPLES = os.path.join(ROOT, "samples")
LOW_CAP = 64
PRECS = [Precision.SINGLE, Precision.HALF]

# (h, w, u, r2c, planes_format, bank set) of the big routes with the cap
# lowered: the staged quad (128-aligned and not), the r2c grid (u = 3, 4
# and p/q = 3/2, 5/4), the c2c grid at p = 2, 3, p/q = 5/2 (p > 4 runs the
# grid above the cap) and 9/4 (p = 9 > 8: woven planes and K3)
LOW_CAP_ROUTES = [
    (32, 128, 2.0, True, "quad", "staged"),
    (96, 120, 2.0, True, "quad", "staged"),
    (36, 96, 3.0, True, "grid", "grid"),
    (32, 128, 4.0, True, "grid", "grid"),
    (64, 256, 1.5, True, "grid", "grid"),
    (32, 512, 1.25, True, "grid", "grid"),
    (48, 256, 2.0, False, "grid", "c2cgrid"),
    (36, 96, 3.0, False, "grid", "c2cgrid"),
    (64, 256, 2.5, False, "grid", "c2cgrid"),
    (64, 256, 2.25, False, "grid", "c2cgrid"),
]


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))


@pytest.fixture()
def low_cap(monkeypatch):
    """Lower the dense cap in both packages; built pipelines are dropped
    before and after, so no plan keeps a pipeline of the other cap."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu

    tpipe._build.cache_clear()
    monkeypatch.setattr(plan_mod, "DENSE_MAX", LOW_CAP)
    monkeypatch.setattr(jmxu, "DENSE_MAX", LOW_CAP)
    yield
    tpipe._build.cache_clear()


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _hwc(out, fmt):
    """A route's planes (or planar image) as the (H, W, C) host image."""
    if fmt is None:
        return out.numpy()
    planes = [p.numpy() for p in out]
    return np.moveaxis(png.weave_grid_host(planes, int(round(len(planes) ** 0.5))), 0, -1)


def _jax_pipeline(img, h, w, u, r2c, prec, engine="auto"):
    """JAX's build_upscale at the plan, outside its plan cache (the cap may
    be lowered): on the CPU its generic branch, XLA CAS."""
    from vkresample_tpu.pipeline.upscale import build_upscale as jbuild

    jplan = JPlan(h=h, w=w, upscale=u, r2c=r2c, precision=JPrecision(int(prec)),
                  engine=JEngine(engine))
    return np.asarray(jbuild.__wrapped__(jplan)(jnp.asarray(img)))


def _check_route(h, w, u, r2c, prec, fmt, tag, engine=Engine.AUTO):
    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=prec, engine=engine)
    assert tpipe.planes_format(plan) == fmt
    if tpipe.route_engine(plan) is Engine.MXU:
        assert mxu_pipeline.bank_set(plan) == tag
    img = _img(h, w, seed=h + w + int(4 * u) + int(prec))
    want = toracle.upscale_oracle(img, plan)
    woven = build_upscale(plan, "cpu")(img).numpy()
    assert woven.shape == (plan.H, plan.W, 3)
    assert _maxdiff(woven, want) <= 1
    if fmt is not None:
        planes = build_upscale(plan, "cpu", planes_out=True)(img)
        assert all(p.dtype == torch.uint8 for p in planes)
        np.testing.assert_array_equal(_hwc(planes, fmt), woven)
    return img, woven


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("h,w,u,r2c,fmt,tag", LOW_CAP_ROUTES)
def test_big_routes_match_oracle_and_jax(low_cap, h, w, u, r2c, fmt, tag, prec):
    """Each big route, planes and woven, within 1 LSB of the oracle and of
    JAX's _pipeline at the same plan (the woven planes equal the woven
    call); JAX's bank set is the same kind."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu

    img, woven = _check_route(h, w, u, r2c, prec, fmt, tag)
    jplan = JPlan(h=h, w=w, upscale=u, r2c=r2c, precision=JPrecision(int(prec)))
    jb = jmxu.make_dense_banks(jplan, "float32")
    key = {"staged": "stx_b1", "grid": "sgx1_b1", "c2cgrid": "cg_ay"}[tag]
    assert key in jb
    assert _maxdiff(woven, _jax_pipeline(img, h, w, u, r2c, prec)) <= 1


@pytest.mark.parametrize("h,w,u,r2c", [(32, 128, 2.0, True), (36, 96, 3.0, False),
                                       (30, 42, 1.5, True)])
def test_reference_tier_above_lowered_cap(low_cap, h, w, u, r2c):
    """-engine xla above the cap: torch.fft + K3, within 1 LSB of the
    oracle and of JAX's reference tier."""
    img, woven = _check_route(h, w, u, r2c, Precision.SINGLE, None, None, Engine.XLA)
    assert _maxdiff(woven, _jax_pipeline(img, h, w, u, r2c, Precision.SINGLE, "xla")) <= 1


def test_big_integer_plan_without_staged_form_runs_reference_tier(low_cap):
    """The port's one routing departure: an integer MXU plan above the cap
    that no staged form takes (h = 4 has no Cooley-Tukey split) runs the
    reference tier and K3, where the JAX package runs its phases route;
    the output is within 1 LSB of the oracle and of JAX's."""
    plan = UpscalePlan(h=4, w=96, upscale=2.0)
    assert plan.mxu_mode == "phases" and mxu_pipeline.bank_set(plan) is None
    assert tpipe.route_engine(plan) is Engine.XLA
    img, woven = _check_route(4, 96, 2.0, True, Precision.SINGLE, None, None)
    assert _maxdiff(woven, _jax_pipeline(img, 4, 96, 2.0, True, Precision.SINGLE)) <= 1


def test_big_fraction_without_grid_raises(low_cap):
    """A fractional plan above the cap that no staged grid takes raises
    JAX's ValueError at build time (5/3 at 60 rows: the C-float band drops
    a y bin, so the rational keep set does not hold)."""
    plan = UpscalePlan(h=60, w=96, upscale=1.6666667)
    assert plan.mxu_mode == "big" and mxu_pipeline.bank_set(plan) is None
    assert tpipe.planes_format(plan) is None
    with pytest.raises(ValueError, match="staged fractional grid"):
        build_upscale(plan, "cpu")


# ---------------------------------------------------------------------------
# over the real cap, at thin shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,u,r2c,prec,fmt,tag,engine", [
    # the staged quad at a 7-smooth width 128 does not divide: (64, 16800)
    (32, 8400, 2.0, True, Precision.HALF, "quad", "staged", Engine.AUTO),
    (32, 8400, 2.0, True, Precision.SINGLE, "quad", "staged", Engine.AUTO),
    # the r2c big grid: (96, 8400)
    (32, 2800, 3.0, True, Precision.HALF, "grid", "grid", Engine.AUTO),
    # the c2c grid above the cap, p = 2 and 3
    (32, 8400, 2.0, False, Precision.HALF, "grid", "c2cgrid", Engine.AUTO),
    (32, 2800, 3.0, False, Precision.SINGLE, "grid", "c2cgrid", Engine.AUTO),
    # the reference tier: -engine xla, and AUTO at a width that is not
    # 7-smooth (8202 = 2 * 3 * 1367), and an integer plan with no staged form
    (4, 8400, 2.0, True, Precision.SINGLE, None, None, Engine.XLA),
    (4, 8202, 2.0, True, Precision.SINGLE, None, None, Engine.AUTO),
    (4, 8400, 2.0, True, Precision.HALF, None, None, Engine.AUTO),
    (4, 4200, 2.0, False, Precision.SINGLE, None, None, Engine.XLA),
])
def test_over_the_real_cap(h, w, u, r2c, prec, fmt, tag, engine):
    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=prec, engine=engine)
    assert plan.above_dense_cap
    _check_route(h, w, u, r2c, prec, fmt, tag, engine)
    expect = Engine.MXU if tag else Engine.XLA
    assert tpipe.route_engine(plan) is expect


def test_big_frames_batch(low_cap):
    """A batch of big frames folds into the kernels' plane axis: each frame
    equals its single-frame call."""
    from vkresample_tpu_torch import build_batched_upscale

    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.HALF)
    imgs = np.stack([_img(32, 128, seed=s) for s in range(3)])
    planes = build_batched_upscale(plan, "cpu", planes_out=True)(imgs)
    assert len(planes) == 4 and planes[0].shape == (3, 3, 32, 128)
    one = build_upscale(plan, "cpu", planes_out=True)
    for i in range(3):
        for a, b in zip(planes, one(imgs[i])):
            assert torch.equal(a[i], b)


# ---------------------------------------------------------------------------
# the channel-serial loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,u,r2c,prec,low", [
    (32, 128, 2.0, True, Precision.HALF, False),  # quad (small tier)
    (36, 96, 3.0, True, Precision.SINGLE, False),  # rows + K5
    (32, 128, 2.0, True, Precision.HALF, True),  # staged quad
    (36, 96, 3.0, False, Precision.HALF, True),  # c2c grid
    (32, 128, 2.0, True, Precision.DOUBLE, True),  # fp64
    (30, 42, 1.5, True, Precision.SINGLE, False),  # chain + K3
])
def test_channel_serial_matches_batched(monkeypatch, h, w, u, r2c, prec, low):
    """Above CHANNEL_SERIAL_ELEMS output elements a frame runs one channel
    at a time; every output surface (planes, woven, planar, a batch of
    frames) is identical to the channel-batched form."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu

    tpipe._build.cache_clear()
    if low:
        monkeypatch.setattr(plan_mod, "DENSE_MAX", LOW_CAP)
        monkeypatch.setattr(jmxu, "DENSE_MAX", LOW_CAP)
    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=prec)
    fmt = tpipe.planes_format(plan)
    img = _img(h, w, seed=7)
    imgs = np.stack([img, _img(h, w, seed=8)])
    calls = [dict(), dict(planar_out=True)] + ([dict(planes_out=True)] if fmt else [])

    def outs():
        got = [build_upscale(plan, "cpu", **kw)(img) for kw in calls]
        return got + [build_upscale(plan, "cpu")(imgs)]

    batched = outs()
    tpipe._build.cache_clear()
    monkeypatch.setattr(tpipe, "CHANNEL_SERIAL_ELEMS", plan.H * plan.W)  # 3 channels pass it
    assert tpipe._channel_serial(plan, torch.from_numpy(img))
    serial = outs()
    tpipe._build.cache_clear()
    for a, b in zip(batched, serial):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.shape == y.shape and torch.equal(x, y)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(capsys, *args):
    capsys.readouterr()
    rc = cli.main(list(args), device="cpu")
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("args", [("-u", "2", "-p", "2"), ("-u", "2", "-p", "1"),
                                  ("-c2c", "-u", "2"), ("-u", "2", "-engine", "xla")])
def test_cli_over_the_cap(tmp_path, capsys, args):
    """A thin frame whose output passes the cap (32x4200 -> 64x8400) runs
    through -i/-o and validates within 1 LSB of the oracle."""
    src, out = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    png.write_png(src, _img(32, 4200, seed=42))
    rc, stdout = _cli(capsys, "-i", src, "-o", out, *args, "-validate")
    assert rc == 0, stdout
    assert "(tol 1) OK" in stdout and "4200x32 to 8400x64" in stdout
    assert png.read_png(out).shape == (64, 8400, 3)
