"""The port's c2c spectrum path (CPU, plain versions) against the JAX
package on the CPU: the staged grid banks and transform, the dense c2c
chain, every c2c route end to end against the fp64 oracle and the JAX
upscale(r2c=False), routing, the device and host grid weaves, the grid PNG
writer and the CLI's -c2c.

Tolerances, by what is compared:
- banks in f64: 1e-12 (the same numpy arithmetic);
- staged planes in f32, same banks: <= 2e-4 in CAS units (float32 stage
  sums in another order; measured <= 6e-7);
- staged planes in -p 2: <= 2 Q2.14 ticks (a tick flips where the f32
  magnitudes straddle a rounding edge; measured <= 1);
- the c2c chain in f32, same banks: <= 2e-5;
- uint8 images: <= 1 LSB (the JAX package's own bar against the oracle)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkresample_tpu.core.config import Engine as JEngine
from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.core.plan import UpscalePlan as JPlan
from vkresample_tpu.fft import dense as jdense
from vkresample_tpu.fft import staged as jstaged
from vkresample_tpu.ops import cas as jcas
from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale, cli, upscale
from vkresample_tpu_torch.fft import dense, mxu_pipeline, staged
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.ops import cas, weave
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe
from vkresample_tpu_torch.weights import banks_from_jax

HIGHEST = jax.lax.Precision.HIGHEST
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SAMPLES = os.path.join(ROOT, "samples")
PRECS = [Precision.SINGLE, Precision.HALF]
_CODEC = dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
_JCODEC = dict(store=jcas.to_i16_storage, load=jcas.from_i16_storage)

# (h, w, u): staged grid geometries (p = 2, 3, 3/2 with q = 2, 4, and a
# width that 128 does not divide)
GRID_GEOMS = [(48, 256, 2.0), (36, 384, 3.0), (48, 256, 1.5), (32, 256, 4.0), (40, 200, 3.0)]

# (h, w, u, engine, route): one plan per c2c route of the port
ROUTES = [
    (48, 256, 2.0, Engine.AUTO, "grid p=2"),
    (36, 384, 3.0, Engine.AUTO, "grid p=3"),
    (32, 256, 4.0, Engine.AUTO, "grid p=4"),
    (48, 256, 1.5, Engine.AUTO, "grid p/q=3/2"),
    (32, 64, 2.5, Engine.AUTO, "chain u=2.5"),
    (36, 50, 1.0, Engine.AUTO, "chain u=1"),
    (32, 64, 2.0, Engine.XLA, "reference tier"),
    (30, 42, 1.5, Engine.XLA, "reference tier, fractional"),
]


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _plans(h, w, u, **kw):
    jkw = {k: (JPrecision(int(v)) if k == "precision" else JEngine(v.value) if k == "engine"
               else v) for k, v in kw.items()}
    return JPlan(h=h, w=w, upscale=u, r2c=False, **jkw), UpscalePlan(h=h, w=w, upscale=u,
                                                                     r2c=False, **kw)


# ---------------------------------------------------------------------------
# banks and transforms against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,u", GRID_GEOMS)
def test_staged_banks_match_jax(h, w, u):
    """c2c grid banks field by field in f64; the port drops only the JAX
    experimental codecs' qb/dc0 entries."""
    jplan, plan = _plans(h, w, u)
    assert staged.c2c_grid_params(plan) == jstaged.c2c_grid_params(jplan)
    jb = jstaged.c2c_grid_staged_banks(jplan, "float64")
    tb = staged.c2c_grid_staged_banks(plan, "float64")
    assert set(tb) == {k for k in jb if not k.endswith(("_qb", "_dc0"))}
    for key in tb:
        assert tb[key].shape == jb[key].shape, key
        np.testing.assert_allclose(tb[key], jb[key], rtol=0, atol=1e-12, err_msg=key)


def test_stage_splits_at_full_frames_match_jax():
    """The stage splits of the chip routes' frames equal JAX's: the y n1 of
    720 and 540 rows (30, 20), and the decimated x split at 1280 wide for
    q=2, whose middle bank is (3, 2, 256, 2, 128)."""
    for n, q in [(720, 1), (540, 1), (720, 2), (1280, 2), (1280, 1), (960, 1), (600, 1)]:
        assert staged.split_factors(n, multiple_of=q) == jstaged.split_factors(n, multiple_of=q)
        assert staged.x_split_prefer(q, n=n) == jstaged.x_split_prefer(q, n=n)
    assert staged.split_factors(720)[0] == 30 and staged.split_factors(540)[0] == 20
    n1, n2 = staged.split_factors(1280, staged.x_split_prefer(2, n=1280), multiple_of=2)
    assert (n2 // 2 + 1, 2, n1, 2, n1 // 2) == (3, 2, 256, 2, 128)


@pytest.mark.parametrize("codec", ["f32", "i16"])
@pytest.mark.parametrize("h,w,u", GRID_GEOMS)
def test_c2c_grid_staged_matches_jax(h, w, u, codec):
    """The p^2 magnitude planes with the same banks (banks_from_jax) as
    JAX's c2c_grid_staged at HIGHEST, without and with the Q2.14 codec."""
    jplan, plan = _plans(h, w, u)
    jb = jstaged.c2c_grid_staged_banks(jplan)
    x = np.moveaxis(_img(h, w, seed=h + w + int(2 * u))[..., :2], -1, 0).copy()
    if codec == "f32":
        want = jstaged.c2c_grid_staged(jnp.asarray(x), jb, HIGHEST)
        got = staged.c2c_grid_staged(torch.from_numpy(x), banks_from_jax(jb, "cpu"))
    else:
        want = jstaged.c2c_grid_staged(jnp.asarray(x), jb, HIGHEST, **_JCODEC)
        got = staged.c2c_grid_staged(torch.from_numpy(x), banks_from_jax(jb, "cpu"), **_CODEC)
    p, q = staged.c2c_grid_params(plan)
    assert len(got) == p * p
    for a, b in zip(want, got):
        assert b.shape == (2, h // q, w // q)
        if codec == "f32":
            assert b.dtype == torch.float32
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 2e-4
        else:
            assert b.dtype == torch.int16
            assert np.abs(np.asarray(a).astype(np.int32) - b.numpy().astype(np.int32)).max() <= 2


@pytest.mark.parametrize("h,w,u", [(32, 64, 2.5), (36, 50, 1.0), (45, 64, 1.0)])
def test_c2c_chain_matches_jax(h, w, u):
    """c2c chain banks field by field in f64, and c2c_chain with the same
    f32 banks."""
    jplan, plan = _plans(h, w, u)
    jb64 = jdense.c2c_chain_banks(jplan, "float64")
    tb64 = dense.c2c_chain_banks(plan, "float64")
    assert set(tb64) == set(jb64)
    for key in jb64:
        np.testing.assert_allclose(tb64[key], jb64[key], rtol=0, atol=1e-12, err_msg=key)
    jb = jdense.c2c_chain_banks(jplan, "float32")
    x = (np.moveaxis(_img(h, w, seed=h * w)[..., :2], -1, 0) / 255.0).astype(np.float32)
    want = np.asarray(jdense.c2c_chain(jnp.asarray(x), jb, HIGHEST))
    got = dense.c2c_chain(torch.from_numpy(x), banks_from_jax(jb, "cpu"))
    assert got.shape == (2, plan.H, plan.W)
    assert np.abs(want - got.numpy()).max() <= 2e-5


@pytest.mark.parametrize("h,w,u", [(36, 384, 3.0), (48, 256, 1.5), (32, 64, 2.5)])
def test_upscale_precas_mxu_c2c_matches_jax(h, w, u):
    """The woven float pre-CAS image of both c2c bank kinds against JAX's
    upscale_precas_mxu with the same banks."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu

    jplan, plan = _plans(h, w, u)
    x = (_img(h, w, seed=int(u * 10))[..., 0] / 255.0).astype(np.float32)
    jb = jmxu.make_dense_banks(jplan)
    assert ("cg_ay" in jb) == mxu_pipeline.c2c_grid_selected(plan)
    want = np.asarray(jmxu.upscale_precas_mxu(jnp.asarray(x), jplan, jb))
    got = mxu_pipeline.upscale_precas_mxu(torch.from_numpy(x), plan, banks_from_jax(jb, "cpu"))
    assert got.shape == (plan.H, plan.W)
    assert np.abs(want - got.numpy()).max() <= 2e-4


def test_grid_weaves_match_jax():
    """weave_grid_u8 against JAX's and against the host weave, u = 3, 4."""
    from vkresample_tpu.ops import weave as jweave

    for u in (3, 4):
        P = [np.random.default_rng(s).integers(0, 256, (2, 3, 5), np.uint8) for s in range(u * u)]
        got = weave.weave_grid_u8([torch.from_numpy(p) for p in P], u).numpy()
        np.testing.assert_array_equal(got, np.asarray(jweave.weave_grid_u8(P, u)))
        np.testing.assert_array_equal(got, png.weave_grid_host(P, u))
    with pytest.raises(TypeError, match="uint8"):
        weave.weave_grid_u8([torch.zeros((1, 2, 2))] * 4, 2)


# ---------------------------------------------------------------------------
# routes end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("h,w,u,engine,route", ROUTES)
def test_c2c_route_matches_oracle(h, w, u, engine, route, prec):
    """upscale(r2c=False) (woven) and, on the grid routes, the grid planes
    of build_upscale within 1 LSB of the fp64 oracle; the planes woven on
    the host equal the woven output."""
    img = _img(h, w, seed=h * w + int(prec))
    _, plan = _plans(h, w, u, precision=prec, engine=engine)
    want = toracle.upscale_oracle(img, plan)
    out = upscale(img, u, precision=prec, r2c=False, engine=engine, device="cpu")
    assert out.shape == (plan.H, plan.W, 3) and out.dtype == torch.uint8
    assert _maxdiff(out.numpy(), want) <= 1
    fmt = tpipe.planes_format(plan)
    assert fmt == ("grid" if route.startswith("grid") else None)
    if fmt:
        planes = build_upscale(plan, "cpu", planes_out=True)(img)
        p = staged.c2c_grid_params(plan)[0]
        assert len(planes) == p * p
        woven = png.weave_grid_host([q.numpy() for q in planes], p)
        np.testing.assert_array_equal(np.moveaxis(woven, 0, -1), out.numpy())
    else:
        with pytest.raises(ValueError, match="no parity-plane output"):
            build_upscale(plan, "cpu", planes_out=True)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("h,w,u,engine,route", ROUTES)
def test_c2c_route_matches_jax_upscale(h, w, u, engine, route, prec):
    """Against the JAX package's upscale(r2c=False) on the CPU (its generic
    branch: the staged grid or chain woven, then cas_sharpen): within 1
    LSB."""
    from vkresample_tpu import upscale as jupscale

    img = _img(h, w, seed=h + w + int(prec))
    jplan, plan = _plans(h, w, u, precision=prec, engine=engine)
    want = np.asarray(jupscale(img, u, plan=jplan))
    assert _maxdiff(upscale(img, u, plan=plan, device="cpu").numpy(), want) <= 1


def test_c2c_routing_matches_jax(monkeypatch):
    """c2c_grid_selected and planes_format against JAX's over a sweep of
    geometries (the chip routes' frames among them).  JAX's planes_format is
    None off a TPU, so its Pallas gate is opened for the comparison as on
    its chip, where fp64 stays off the kernels."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu
    from vkresample_tpu.pipeline import upscale as jpipe

    monkeypatch.setattr(jpipe, "_use_pallas_cas",
                        lambda plan: plan.precision is not JPrecision.DOUBLE)
    n = 0
    for h, w in [(1024, 2048), (720, 1280), (540, 960), (400, 600), (1080, 1920), (64, 96),
                 (45, 63), (36, 50), (30, 42), (2, 2), (4096, 4100), (128, 256)]:
        for u in (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 4 / 3, 5.0):
            for r2c in (True, False):
                for prec in Precision:
                    try:
                        jplan = JPlan(h=h, w=w, upscale=u, r2c=r2c, precision=JPrecision(int(prec)))
                    except ValueError:
                        continue
                    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=prec)
                    assert (mxu_pipeline.c2c_grid_selected(plan)
                            == jmxu.c2c_grid_selected(jplan)), (h, w, u, r2c, prec)
                    assert tpipe.planes_format(plan) == jpipe.planes_format(jplan), (
                        h, w, u, r2c, prec)
                    n += 1
    assert n > 150
    for h, w, u, want in [(1024, 2048, 2.0, "grid"), (720, 1280, 3.0, "grid"),
                          (720, 1280, 1.5, "grid"), (540, 960, 4.0, "grid"),
                          (400, 600, 3.0, "grid"), (720, 1280, 2.5, None), (720, 1280, 1.0, None)]:
        assert tpipe.planes_format(UpscalePlan(h=h, w=w, upscale=u, r2c=False)) == want


# ---------------------------------------------------------------------------
# CLI and the grid PNG writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["zlib", "native"])
@pytest.mark.parametrize("args", [("-u", "2", "-p", "2"), ("-u", "3"), ("-u", "1.5", "-p", "2")])
def test_cli_c2c_writes_validated_grid_png(tmp_path, capsys, monkeypatch, args, codec):
    """-c2c through the CLI (in-process on the CPU): -validate passes and
    the grid PNG, through either codec, equals upscale(r2c=False)."""
    if codec == "zlib":
        monkeypatch.setattr(png, "_native", lambda: None)
    elif png._native() is None:
        pytest.skip("native codec unavailable (no g++ or libpng)")
    sample = os.path.join(SAMPLES, "test_256x128.png")
    out = tmp_path / "o.png"
    capsys.readouterr()
    rc = cli.main(["-i", sample, "-o", str(out), "-c2c", *args, "-validate"], device="cpu")
    stdout = capsys.readouterr().out
    assert rc == 0 and "(tol 1) OK" in stdout, stdout
    kw = dict(zip(args[0::2], args[1::2]))
    plan = UpscalePlan(h=128, w=256, upscale=float(kw["-u"]), r2c=False,
                       precision=Precision(int(kw.get("-p", 0))))
    assert tpipe.planes_format(plan) == "grid"
    np.testing.assert_array_equal(png.read_png(str(out)),
                                  upscale(np.asarray(png.read_png(sample)), 0, plan=plan,
                                          device="cpu").numpy())


@pytest.mark.parametrize("codec", ["zlib", "native"])
def test_grid_png_writer_roundtrip(tmp_path, codec, monkeypatch):
    """write_png_planar_grid decodes to the host-woven image through either
    codec, and rejects a wrong plane count."""
    if codec == "zlib":
        monkeypatch.setattr(png, "_native", lambda: None)
    elif png._native() is None:
        pytest.skip("native codec unavailable (no g++ or libpng)")
    rng = np.random.default_rng(6)
    for u in (2, 3):
        P = [rng.integers(0, 256, (3, 4, 7), np.uint8) for _ in range(u * u)]
        path = str(tmp_path / f"g{u}.png")
        png.write_png_planar_grid(path, P, u)
        np.testing.assert_array_equal(png._zlib_read(path), np.moveaxis(png.weave_grid_host(P, u), 0, -1))
    with pytest.raises(ValueError, match="9 matching"):
        png.write_png_planar_grid(str(tmp_path / "x.png"), P[:8], 3)
