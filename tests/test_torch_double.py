"""fp64 (-p 1) on the port's routes (CPU): the float64 staged, grid and
c2c-grid bank sets, the dense float64 banks where no staged form applies,
the float64 reference tier, and the banded float64 CAS; against the fp64
oracle and the JAX package's upscale(precision=DOUBLE) on the CPU, and the
CLI's -p 1.

What fp64 gives: the sample pixels of an integer factor reproduce the input
exactly, 255 * v = k, wherever CAS leaves them alone (a neighbourhood that
reaches 0 or 1 sets its weight to 0), so the truncating quantize lands
exactly on an integer and the last bits of the pre-CAS value decide between
k and k - 1.  There the CAS weight's square root, sqrt((1 - max)/max) or
sqrt(min/(1 - min)), turns an error e of the transform into about sqrt(e):
1e-13 of float64 rounding moves the output by some 1e-5 LSB.  The oracle
(numpy's FFT), the JAX package (XLA's) and the port (torch's, or its
float64 GEMMs) round each their own way: on the CPU JAX's DOUBLE upscale is
1 LSB from the oracle at a few pixels a frame, and so is the port's.  The
bar here is exactness everywhere else: a pixel may differ from the oracle
or from JAX only where the oracle's 255 * sharpened value is within EDGE
of an integer, and then by 1 LSB; a uniform value lands that close to an
integer 2e-4 of the time."""
import os

import numpy as np
import pytest
import torch

from vkresample_tpu.core.config import Engine as JEngine
from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.core.plan import UpscalePlan as JPlan
from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale, cli, upscale
from vkresample_tpu_torch.core import plan as plan_mod
from vkresample_tpu_torch.fft import mxu_pipeline
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SAMPLES = os.path.join(ROOT, "samples")
EDGE = 1e-4  # in uint8 units

# (h, w, u, r2c, engine, the bank set or tier): one plan per -p 1 route
ROUTES = [
    (32, 128, 2.0, True, Engine.AUTO, "staged64"),
    (96, 120, 2.0, True, Engine.AUTO, "staged64"),
    (36, 96, 3.0, True, Engine.AUTO, "grid64"),
    (64, 256, 1.5, True, Engine.AUTO, "grid64"),
    (48, 256, 2.0, False, Engine.AUTO, "c2cgrid64"),
    (36, 96, 3.0, False, Engine.AUTO, "c2cgrid64"),
    (30, 42, 1.5, True, Engine.AUTO, "chain"),
    (64, 63, 2.0, True, Engine.AUTO, "rows"),
    (30, 42, 1.0, False, Engine.AUTO, "c2c"),
    (32, 128, 2.0, True, Engine.XLA, "xla"),
    (32, 64, 2.0, False, Engine.XLA, "xla"),
]


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _oracle_edges(img, plan):
    """The oracle's uint8 image and the mask of its pixels whose 255 *
    sharpened value is within EDGE of an integer (in [0, 255])."""
    u2 = float(np.float32(plan.upscale)) ** 2
    edges = np.empty((plan.H, plan.W, img.shape[-1]), bool)
    for ch in range(img.shape[-1]):
        f = img[:, :, ch].astype(np.float64) / 255.0
        if plan.r2c:
            G = toracle.assemble_big_spectrum(np.fft.rfft2(f), plan)
            y = np.fft.irfft2(G, s=(plan.H, plan.W))
        else:
            y = np.fft.ifft2(toracle.assemble_big_spectrum(np.fft.fft2(f), plan))
        s = np.clip(255.0 * toracle.cas_sharpen(u2 * y, plan.sharpen, not plan.r2c), 0, 255)
        edges[:, :, ch] = np.abs(s - np.round(s)) < EDGE
    return toracle.upscale_oracle(img, plan), edges


def _exact_off_edges(got, want, edges):
    d = np.abs(np.asarray(got).astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert not (d > 0)[~edges].any(), "differs away from a truncation edge"


@pytest.mark.parametrize("h,w,u,r2c,engine,tier", ROUTES)
def test_double_routes_match_oracle_and_jax(h, w, u, r2c, engine, tier):
    """upscale(precision=DOUBLE) on each route: exact against the oracle
    and against JAX's DOUBLE upscale away from the truncation edges."""
    from vkresample_tpu import upscale as jupscale

    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=Precision.DOUBLE,
                       engine=engine)
    assert tpipe.planes_format(plan) is None
    if engine is Engine.AUTO:
        assert tpipe.route_engine(plan) is Engine.MXU
        assert mxu_pipeline.bank_set(plan) == tier
    img = _img(h, w, seed=h + w + int(4 * u))
    got = upscale(img, u, plan=plan, device="cpu")
    assert got.shape == (plan.H, plan.W, 3) and got.dtype == torch.uint8
    want, edges = _oracle_edges(img, plan)
    _exact_off_edges(got.numpy(), want, edges)
    jplan = JPlan(h=h, w=w, upscale=u, r2c=r2c, precision=JPrecision.DOUBLE,
                  engine=JEngine(engine.value))
    jgot = np.asarray(jupscale(img, u, plan=jplan))
    _exact_off_edges(jgot, want, edges)  # the JAX package's own fp64 result
    _exact_off_edges(got.numpy(), jgot, edges)


@pytest.mark.parametrize("h,w,u,r2c,engine", [
    (32, 8400, 2.0, True, Engine.AUTO),  # staged64 over the real cap
    (32, 2800, 3.0, True, Engine.AUTO),  # grid64
    (32, 4200, 2.0, False, Engine.AUTO),  # c2cgrid64
    (4, 8400, 2.0, True, Engine.AUTO),  # no staged form: the float64 reference tier
    (4, 4200, 2.0, True, Engine.XLA),
])
def test_double_over_the_cap(h, w, u, r2c, engine):
    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=Precision.DOUBLE,
                       engine=engine)
    assert plan.above_dense_cap
    img = _img(h, w, seed=w)
    want, edges = _oracle_edges(img, plan)
    _exact_off_edges(build_upscale(plan, "cpu")(img).numpy(), want, edges)


def test_double_staged_at_every_size(monkeypatch):
    """The float64 staged sets serve -p 1 at every size, so lowering the
    cap changes no bank set and no output."""
    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.DOUBLE)
    img = _img(32, 128, seed=3)
    tpipe._build.cache_clear()
    below = build_upscale(plan, "cpu")(img)
    tpipe._build.cache_clear()
    monkeypatch.setattr(plan_mod, "DENSE_MAX", 64)
    assert plan.above_dense_cap and mxu_pipeline.bank_set(plan) == "staged64"
    above = build_upscale(plan, "cpu")(img)
    tpipe._build.cache_clear()
    assert torch.equal(below, above)


def test_double_banks_are_float64():
    for kw in (dict(h=32, w=128, upscale=2.0), dict(h=36, w=96, upscale=3.0),
               dict(h=48, w=256, upscale=2.0, r2c=False), dict(h=30, w=42, upscale=1.5),
               dict(h=30, w=42, upscale=1.0, r2c=False)):
        banks = mxu_pipeline.make_dense_banks(UpscalePlan(precision=Precision.DOUBLE, **kw))
        assert all(np.asarray(v).dtype == np.float64 for v in banks.values()), kw


def test_double_has_no_parity_planes():
    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.DOUBLE)
    with pytest.raises(ValueError, match="no parity-plane output"):
        build_upscale(plan, "cpu", planes_out=True)


# ---------------------------------------------------------------------------
# the banded float64 CAS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("band", [1, 7, 2, 37, None])
@pytest.mark.parametrize("shape", [(2, 37, 50), (37, 50), (2, 1, 3, 9)])
def test_banded_cas_equals_whole_image(shape, band, dtype):
    """cas_quantize_banded is identical to quantize_u8(cas_sharpen(v)) on
    every pixel at band heights 1, 7, 2, H (37) and the default."""
    g = torch.Generator().manual_seed(sum(shape))
    v = (torch.rand(shape, generator=g, dtype=torch.float64) * 1.3 - 0.1).to(dtype)
    want = cas.quantize_u8(cas.cas_sharpen(v, 0.2))
    got = cas.cas_quantize_banded(v, 0.2, band)
    assert got.dtype == torch.uint8 and torch.equal(got, want)


def test_banded_cas_default_band_rows(monkeypatch):
    """The default band holds BAND_ELEMS elements: a frame larger than one
    band runs in several, with the same output."""
    monkeypatch.setattr(cas, "BAND_ELEMS", 3 * 64 * 5)
    v = torch.rand((3, 61, 64), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    assert torch.equal(cas.cas_quantize_banded(v, 0.2), cas.quantize_u8(cas.cas_sharpen(v, 0.2)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_double_validate(tmp_path, capsys):
    """-p 1 -validate on the 256x128 sample: within its 1 LSB tolerance of
    the oracle, the woven image written."""
    out = str(tmp_path / "o.png")
    capsys.readouterr()
    rc = cli.main(["-i", os.path.join(SAMPLES, "test_256x128.png"), "-o", out, "-u", "2",
                   "-p", "1", "-validate"], device="cpu")
    stdout = capsys.readouterr().out
    assert rc == 0 and "(tol 1) OK" in stdout, stdout
    assert png.read_png(out).shape == (256, 512, 3)
