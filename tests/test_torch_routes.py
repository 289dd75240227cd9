"""The port's woven and rows-parity routes (CPU, plain versions): the rows
and chain transforms and their banks against the JAX package, every route
end to end against the fp64 oracle and the JAX upscale(), the goldens
through both engines, routing against JAX, the CLI and the planar PNG
writers.

Tolerances, by what is compared:
- transforms in f32: float32 rounding of the GEMMs, |diff| <= 2e-5 in CAS
  units (the JAX x bank is a bf16 hi|lo split, ~2^-18 relative);
- transforms in -p 2: <= 1 Q2.14 tick with the same banks; <= 2 ticks in
  the odd rows with the port's own banks (ROADMAP.md §3);
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
from vkresample_tpu.ops import cas as jcas
from vkresample_tpu_torch import Engine, Precision, UpscalePlan, build_upscale, cli, upscale
from vkresample_tpu_torch.fft import dense, mxu_pipeline
from vkresample_tpu_torch.io import png
from vkresample_tpu_torch.ops import cas, weave
from vkresample_tpu_torch.ops.spectrum import assemble_big_spectrum
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe
from vkresample_tpu_torch.weights import banks_from_jax

HIGHEST = jax.lax.Precision.HIGHEST
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SAMPLES = os.path.join(ROOT, "samples")
F32_TOL = 2e-5
PRECS = [Precision.SINGLE, Precision.HALF]
_CODEC = dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
_JCODEC = dict(store=jcas.to_i16_storage, load=jcas.from_i16_storage)

# (h, w, u, engine, route): one plan per route of the port
ROUTES = [
    (48, 96, 2.0, Engine.AUTO, "rows u=2"),
    (32, 64, 3.0, Engine.AUTO, "rows u=3"),
    (32, 48, 4.0, Engine.AUTO, "rows u=4"),
    (32, 64, 1.5, Engine.AUTO, "chain"),
    (36, 50, 1.0, Engine.AUTO, "chain u=1"),
    (32, 64, 2.0, Engine.XLA, "reference tier"),
    (30, 42, 1.5, Engine.XLA, "reference tier, fractional"),
]


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _own(banks64: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in banks64.items()}


# ---------------------------------------------------------------------------
# banks and transforms against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,u", [(48, 64, 3.0), (32, 96, 4.0), (24, 40, 5.0)])
def test_rows_banks_u3_plus_match_jax(h, w, u):
    """Row-split banks at u >= 3, field by field in f64 (to 1e-12)."""
    jb = jdense.r2c_rows_banks(JPlan(h=h, w=w, upscale=u), "float64")
    tb = dense.r2c_rows_banks(UpscalePlan(h=h, w=w, upscale=u), "float64")
    assert set(tb) == {"alpha", "Ymat_ns", "Y1n", "beta"}
    assert tb["Ymat_ns"].shape == (h + 1, h * (int(u) - 1))
    np.testing.assert_allclose(tb["alpha"], jb["alpha_hi"], rtol=0, atol=1e-12)
    for key in ("Ymat_ns", "Y1n", "beta"):
        np.testing.assert_allclose(tb[key], jb[key], rtol=0, atol=1e-12)


@pytest.mark.parametrize("h,w,u", [(32, 64, 1.5), (36, 50, 1.0), (45, 63, 1.0), (30, 42, 4 / 3)])
def test_chain_banks_match_jax(h, w, u):
    """Chain banks field by field in f64 (to 1e-12), odd 7-smooth sizes
    included."""
    jb = jdense.r2c_chain_banks(JPlan(h=h, w=w, upscale=u), "float64")
    tb = dense.r2c_chain_banks(UpscalePlan(h=h, w=w, upscale=u), "float64")
    assert set(tb) == set(jb)
    for key in jb:
        assert tb[key].shape == jb[key].shape, key
        np.testing.assert_allclose(tb[key], jb[key], rtol=0, atol=1e-12)


@pytest.mark.parametrize("bank_src", ["own", "jax"])
@pytest.mark.parametrize("u", [2.0, 3.0])
def test_r2c_rows_f32_matches_jax(u, bank_src):
    h, w = 32, 96
    jbanks = jdense.r2c_rows_banks(JPlan(h=h, w=w, upscale=u), "float32")
    img = _img(h, w, seed=int(u) + 5)[..., 0][None].repeat(2, 0)
    want = jdense.r2c_rows(jnp.asarray(img), jbanks, HIGHEST)
    tb = (_own(dense.r2c_rows_banks(UpscalePlan(h=h, w=w, upscale=u)))
          if bank_src == "own" else banks_from_jax(jbanks, "cpu"))
    got = dense.r2c_rows(torch.from_numpy(img), tb)
    assert got[1].shape == (2, h * (int(u) - 1), int(u) * w)
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        assert np.abs(np.asarray(a) - b.numpy()).max() <= F32_TOL


@pytest.mark.parametrize("bank_src", ["own", "jax"])
@pytest.mark.parametrize("u", [2.0, 3.0])
def test_r2c_rows_i16_matches_jax(u, bank_src):
    """Stored U within 1 Q2.14 tick; O within 1 tick with the same banks,
    2 with the port's own (the y GEMM carries U's tick differences)."""
    h, w = 32, 96
    jbanks = jdense.r2c_rows_banks(JPlan(h=h, w=w, upscale=u), "float32")
    img = _img(h, w, seed=int(u) + 9)[..., 0][None]
    want = jdense.r2c_rows(jnp.asarray(img), jbanks, HIGHEST, **_JCODEC)
    tb = (_own(dense.r2c_rows_banks(UpscalePlan(h=h, w=w, upscale=u)))
          if bank_src == "own" else banks_from_jax(jbanks, "cpu"))
    got = dense.r2c_rows(torch.from_numpy(img), tb, **_CODEC)
    dU, dO = (np.abs(np.asarray(a).astype(np.int32) - b.numpy().astype(np.int32)).max()
              for a, b in zip(want, got))
    assert got[0].dtype == got[1].dtype == torch.int16
    assert dU <= 1 and dO <= (1 if bank_src == "jax" else 2), (dU, dO)


@pytest.mark.parametrize("h,w,u", [(32, 64, 1.5), (36, 50, 1.0), (45, 63, 1.0)])
def test_r2c_chain_matches_jax(h, w, u):
    """Same f32 banks on both sides (banks_from_jax) and the port's own."""
    jbanks = jdense.r2c_chain_banks(JPlan(h=h, w=w, upscale=u), "float32")
    x = (_img(h, w, seed=h + w)[..., :2].transpose(2, 0, 1) / 255.0).astype(np.float32)
    want = np.asarray(jdense.r2c_chain(jnp.asarray(x), jbanks, HIGHEST))
    plan = UpscalePlan(h=h, w=w, upscale=u)
    for tb in (banks_from_jax(jbanks, "cpu"), _own(dense.r2c_chain_banks(plan))):
        got = dense.r2c_chain(torch.from_numpy(x), tb)
        assert got.shape == (2, plan.H, plan.W)
        assert np.abs(want - got.numpy()).max() <= F32_TOL


def test_weave_rows_and_precas_match_jax():
    """weave_rows, upscale_precas_mxu (both bank kinds) and the big
    spectrum against their JAX counterparts."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu
    from vkresample_tpu.ops.spectrum import assemble_big_spectrum as jassemble

    rng = np.random.default_rng(3)
    U, O = rng.random((2, 5, 7), np.float32), rng.random((2, 10, 7), np.float32)
    np.testing.assert_array_equal(
        dense.weave_rows(torch.from_numpy(U), torch.from_numpy(O), 3).numpy(),
        np.asarray(jdense.weave_rows(jnp.asarray(U), jnp.asarray(O), 3)),
    )
    for h, w, u in ((24, 32, 3.0), (24, 32, 1.5)):
        jplan, plan = JPlan(h=h, w=w, upscale=u), UpscalePlan(h=h, w=w, upscale=u)
        x = (_img(h, w, seed=1)[..., 0] / 255.0).astype(np.float32)
        jbanks = jmxu.make_dense_banks(jplan)
        want = np.asarray(jmxu.upscale_precas_mxu(jnp.asarray(x), jplan, jbanks))
        got = mxu_pipeline.upscale_precas_mxu(torch.from_numpy(x), plan,
                                              banks_from_jax(jbanks, "cpu"))
        assert np.abs(want - got.numpy()).max() <= F32_TOL
        F = np.fft.rfft2(x).astype(np.complex64)
        np.testing.assert_array_equal(
            assemble_big_spectrum(torch.from_numpy(F), plan).numpy(),
            np.asarray(jassemble(jnp.asarray(F), jplan)),
        )


def test_u8_weaves_match_jax():
    from vkresample_tpu.ops import weave as jweave

    P = [np.random.default_rng(s).integers(0, 256, (2, 3, 5), np.uint8) for s in range(4)]
    tP = [torch.from_numpy(p) for p in P]
    np.testing.assert_array_equal(weave.weave_rows_u8(*tP[:2]).numpy(),
                                  np.asarray(jweave.weave_rows_u8(*P[:2])))
    np.testing.assert_array_equal(weave.weave_quad_u8(*tP).numpy(),
                                  np.asarray(jweave.weave_quad_u8(*P)))
    with pytest.raises(TypeError, match="uint8"):
        weave.weave_rows_u8(tP[0].float(), tP[1].float())


# ---------------------------------------------------------------------------
# routes end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("h,w,u,engine,route", ROUTES)
def test_route_matches_oracle(h, w, u, engine, route, prec):
    """upscale() (woven) and, where the route has them, the parity planes
    of build_upscale within 1 LSB of the fp64 oracle."""
    img = _img(h, w, seed=h * w + int(prec))
    plan = UpscalePlan(h=h, w=w, upscale=u, precision=prec, engine=engine)
    want = toracle.upscale_oracle(img, plan)
    out = upscale(img, u, plan=plan, device="cpu")
    assert out.shape == (plan.H, plan.W, 3) and out.dtype == torch.uint8
    assert _maxdiff(out.numpy(), want) <= 1
    planar = build_upscale(plan, "cpu", planar_out=True)(img)
    np.testing.assert_array_equal(planar.numpy(), np.moveaxis(out.numpy(), -1, 0))
    fmt = tpipe.planes_format(plan)
    assert fmt == ("rows" if route == "rows u=2" else None)
    if fmt:
        E, D = build_upscale(plan, "cpu", planes_out=True)(img)
        woven = np.stack([E.numpy(), D.numpy()], axis=2).reshape(3, plan.H, plan.W)
        np.testing.assert_array_equal(np.moveaxis(woven, 0, -1), out.numpy())
    else:
        with pytest.raises(ValueError, match="no parity-plane output"):
            build_upscale(plan, "cpu", planes_out=True)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("h,w,u,engine,route", ROUTES)
def test_route_matches_jax_upscale(h, w, u, engine, route, prec):
    """Against the JAX package's upscale() on the CPU (its generic branch
    with cas_sharpen): within 1 LSB."""
    from vkresample_tpu import upscale as jupscale

    img = _img(h, w, seed=h + w + int(prec))
    jplan = JPlan(h=h, w=w, upscale=u, precision=JPrecision(int(prec)),
                  engine=JEngine(engine.value))
    want = np.asarray(jupscale(img, u, plan=jplan))
    plan = UpscalePlan(h=h, w=w, upscale=u, precision=prec, engine=engine)
    assert _maxdiff(upscale(img, u, plan=plan, device="cpu").numpy(), want) <= 1


@pytest.mark.parametrize("u,golden", [(2.0, "golden_256x128_x2.png"),
                                      (1.5, "golden_256x128_x1.5.png")])
@pytest.mark.parametrize("engine", [Engine.AUTO, Engine.XLA])
def test_sample_matches_golden(u, golden, engine):
    """The tests/test_golden.py check, on the port's routes."""
    img = png.read_png(os.path.join(SAMPLES, "test_256x128.png"))
    want = png.read_png(os.path.join(SAMPLES, golden))
    plan = UpscalePlan(h=128, w=256, upscale=u, engine=engine)
    got = upscale(img, u, plan=plan, device="cpu")
    assert got.shape == want.shape
    assert _maxdiff(got.numpy(), want) <= 1


def test_routing_matches_jax():
    """_parity_route and r2c_rows_supported against JAX's over a sweep of
    geometries (JAX's planes_format is None off a TPU, so it is not the
    comparison)."""
    from vkresample_tpu.fft.dense import r2c_rows_supported as jrows
    from vkresample_tpu.pipeline.upscale import _parity_route as jroute

    n = 0
    for h, w in [(64, 128), (64, 96), (1080, 1440), (720, 1280), (45, 63), (4096, 4100),
                 (36, 50), (2, 2), (1024, 8192)]:
        for u in (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 4 / 3):
            for r2c in (True, False):
                try:
                    jplan = JPlan(h=h, w=w, upscale=u, r2c=r2c)
                except ValueError:
                    continue
                plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c)
                assert tpipe._parity_route(plan) == jroute(jplan), (h, w, u, r2c)
                assert dense.r2c_rows_supported(plan) == jrows(jplan), (h, w, u, r2c)
                n += 1
    assert n > 80


def test_unported_plans_name_their_item(tmp_path, monkeypatch):
    """The plans that once raised naming their ROADMAP.md item (fp64 and
    axes over the dense cap) build and route as JAX's do: the same
    planes_format (JAX's Pallas gate opened, as on its chip) and the same
    bank set or tier.  The 9000^2 and 10240^2 outputs are checked at build
    time only; the thin over-cap plans of test_torch_bigtier.py run in
    full.  A big fraction that no staged grid takes raises JAX's
    ValueError in both packages."""
    from vkresample_tpu.fft import mxu_pipeline as jmxu
    from vkresample_tpu.pipeline import upscale as jpipe

    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jpipe, "_use_pallas_cas", lambda plan: True)
    keys = ("stx_b1", "sgx1_b1", "cg_ay", "Ymat_ns", "Ymat", "Xr")
    for kw, fmt, tag in [
        (dict(h=30, w=42, upscale=1.5, precision=Precision.DOUBLE), None, "chain"),
        (dict(h=30, w=42, upscale=3.0, r2c=False, precision=Precision.DOUBLE), None, "c2c"),
        (dict(h=3000, w=3000, upscale=3.0), "grid", "grid"),
        (dict(h=4096, w=4096, upscale=2.5, engine=Engine.XLA), None, None),
    ]:
        plan = UpscalePlan(**kw)
        jkw = dict(kw, precision=JPrecision(int(kw.get("precision", 0))),
                   engine=JEngine(kw.get("engine", Engine.AUTO).value))
        jplan = JPlan(**jkw)
        assert tpipe.planes_format(plan) == jpipe.planes_format(jplan) == fmt, kw
        engine = tpipe.route_engine(plan)
        assert engine.value == jplan.resolve_engine().value, kw
        if engine is Engine.MXU:
            assert mxu_pipeline.bank_set(plan) == tag, kw
            tb = mxu_pipeline.make_dense_banks(plan)
            jb = jmxu.make_dense_banks(jplan, "float64" if "precision" in kw else "float32")
            assert [k in tb for k in keys] == [k in jb for k in keys], kw
        assert callable(build_upscale(plan, "cpu"))
    plan = UpscalePlan(h=6144, w=6144, upscale=1.6666667)
    jplan = JPlan(h=6144, w=6144, upscale=1.6666667)
    assert plan.mxu_mode == jplan.mxu_mode == "big"
    assert mxu_pipeline.make_dense_banks(plan) is None and jmxu.make_dense_banks(jplan) is None
    assert tpipe.planes_format(plan) is None
    with pytest.raises(ValueError, match="staged fractional grid"):
        build_upscale(plan, "cpu")
    with pytest.raises(ValueError, match="staged fractional grid"):
        jax.eval_shape(lambda x: jmxu.upscale_precas_mxu(x, jplan),
                       jax.ShapeDtypeStruct((3, 6144, 6144), jnp.float32))


# ---------------------------------------------------------------------------
# CLI and PNG writers
# ---------------------------------------------------------------------------


def _cli(capsys, *args):
    """The CLI in-process on the CPU: (exit code, stdout)."""
    capsys.readouterr()
    rc = cli.main(list(args), device="cpu")
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("args", [("-u", "3", "-p", "2"), ("-u", "2", "-engine", "xla"),
                                  ("-u", "1.5", "-engine", "mxu", "-p", "2")])
def test_cli_validates_woven_routes(tmp_path, capsys, args):
    """The woven routes through the CLI, -validate against the oracle, and
    the PNG equal to upscale() on the same plan."""
    out = tmp_path / "o.png"
    sample = os.path.join(SAMPLES, "test_256x128.png")
    rc, stdout = _cli(capsys, "-i", sample, "-o", str(out), *args, "-validate")
    assert rc == 0, stdout
    assert "(tol 1) OK" in stdout
    img = png.read_png(sample)
    kw = dict(zip(args[0::2], args[1::2]))
    plan = UpscalePlan(h=128, w=256, upscale=float(kw["-u"]),
                       precision=Precision(int(kw.get("-p", 0))),
                       engine=Engine(kw.get("-engine", "auto")))
    np.testing.assert_array_equal(png.read_png(str(out)), upscale(img, 0, plan=plan, device="cpu").numpy())


def test_cli_non_aligned_width_takes_rows_route(tmp_path, capsys):
    """A 96x200 frame (200 % 128 != 0) at u=2: rows-parity planes, written
    by the rows-parity encoder, equal to the woven upscale()."""
    src, out = tmp_path / "in.png", tmp_path / "o.png"
    img = _img(96, 200, seed=12)
    png.write_png(str(src), img)
    plan = UpscalePlan(h=96, w=200, upscale=2.0, precision=Precision.HALF)
    assert tpipe.planes_format(plan) == "rows"
    rc, stdout = _cli(capsys, "-i", str(src), "-o", str(out), "-u", "2", "-p", "2", "-validate")
    assert rc == 0 and "(tol 1) OK" in stdout, stdout
    got = png.read_png(str(out))
    assert got.shape == (192, 400, 3)
    np.testing.assert_array_equal(got, upscale(img, 2.0, plan=plan, device="cpu").numpy())


@pytest.mark.parametrize("codec", ["zlib", "native"])
def test_planar_png_writers_roundtrip(tmp_path, codec, monkeypatch):
    """write_png_planar and write_png_planar_parity decode to the
    host-woven image, through the zlib codec and (where g++ and libpng
    build it) the native one; the two codecs write the same pixels."""
    if codec == "zlib":
        monkeypatch.setattr(png, "_native", lambda: None)
    elif png._native() is None:
        pytest.skip("native codec unavailable (no g++ or libpng)")
    rng = np.random.default_rng(5)
    planar = rng.integers(0, 256, (3, 6, 10), np.uint8)
    e, d = (rng.integers(0, 256, (3, 3, 10), np.uint8) for _ in range(2))
    png.write_png_planar(str(tmp_path / "p.png"), planar)
    png.write_png_planar_parity(str(tmp_path / "r.png"), e, d)
    np.testing.assert_array_equal(png._zlib_read(str(tmp_path / "p.png")),
                                  np.moveaxis(planar, 0, -1))
    woven = np.stack([e, d], axis=2).reshape(3, 6, 10)
    np.testing.assert_array_equal(png._zlib_read(str(tmp_path / "r.png")),
                                  np.moveaxis(woven, 0, -1))
    with pytest.raises(ValueError):
        png.write_png_planar_parity(str(tmp_path / "x.png"), e, d[:, :2])
    with pytest.raises(ValueError):
        png.write_png_planar(str(tmp_path / "x.png"), planar[:2])
