"""Port row-split banks and r2c_quad against the JAX package (CPU).

The JAX side runs vkresample_tpu.fft.dense.r2c_quad at Precision.HIGHEST,
which takes its float32 GEMMs (the int8 digit route is off at HIGHEST).
Its x bank is the bf16 hi|lo split of the f64 bank (relative error ~2^-18),
so against the port's own float32 banks the planes differ by that split's
error; with banks_from_jax both sides use the same bank values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkresample_tpu.core.config import Engine as JEngine
from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.core.plan import UpscalePlan as JPlan
from vkresample_tpu.fft import dense as jdense
from vkresample_tpu.fft import mxu_pipeline
from vkresample_tpu.ops import cas as jcas
from vkresample_tpu_torch.core.plan import UpscalePlan
from vkresample_tpu_torch.fft import dense
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.weights import banks_from_jax

HIGHEST = jax.lax.Precision.HIGHEST
SHAPES = [(64, 128), (128, 256)]
# f32 planes: the JAX bf16-split x bank's error (|x| <= 255 times ~2^-18
# relative per term, summed over w terms) stays below 2e-5
F32_TOL = 2e-5
_CODEC = dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
_JCODEC = dict(store=jcas.to_i16_storage, load=jcas.from_i16_storage)


def _setup(h, w, seed):
    jplan = JPlan(h=h, w=w, upscale=2.0, engine=JEngine.MXU)
    jbanks = mxu_pipeline.make_dense_banks(jplan)
    img = np.random.default_rng(seed).integers(0, 256, (3, h, w), np.uint8)
    return jplan, jbanks, img


def _own_banks(h, w):
    b64 = dense.r2c_rows_banks(UpscalePlan(h=h, w=w, upscale=2.0), "float64")
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in b64.items()}


@pytest.mark.parametrize("h,w", SHAPES + [(48, 256)])
def test_f64_banks_match_jax(h, w):
    """alpha, alpha_odd, Ymat_ns, Y1n and beta equal the JAX f64 banks to
    1e-12 (alpha against JAX's /255-folded alpha, which its f64 bank set
    keeps whole in alpha_hi; alpha_odd against its odd columns)."""
    jb = jdense.r2c_rows_banks(JPlan(h=h, w=w, upscale=2.0), "float64")
    tb = dense.r2c_rows_banks(UpscalePlan(h=h, w=w, upscale=2.0), "float64")
    assert set(tb) == {"alpha", "alpha_odd", "Ymat_ns", "Y1n", "beta"}
    assert not np.asarray(jb["alpha_lo"]).any()
    np.testing.assert_allclose(tb["alpha"], jb["alpha_hi"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tb["alpha_odd"], np.asarray(jb["alpha_hi"], np.float64)[:, 1::2],
        rtol=0, atol=1e-12,
    )
    for key in ("Ymat_ns", "Y1n", "beta"):
        assert tb[key].shape == jb[key].shape, key
        np.testing.assert_allclose(tb[key], jb[key], rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "kw,rows",
    [
        (dict(upscale=3.0), True),  # every integer u >= 2 has row-split banks now
        (dict(upscale=1.5), False),  # fractional: the chain banks serve it
        (dict(upscale=2.0, r2c=False), False),  # c2c: neither (ROADMAP item 6)
    ],
)
def test_banks_reject_other_geometries(kw, rows):
    """The row-split banks take exactly the integer u >= 2 r2c geometries
    (u=3 has no alpha_odd: that key serves the u=2 quad route only)."""
    plan = UpscalePlan(h=64, w=128, **kw)
    if rows:
        assert set(dense.r2c_rows_banks(plan)) == {"alpha", "Ymat_ns", "Y1n", "beta"}
    else:
        with pytest.raises(ValueError, match="integer u >= 2 r2c"):
            dense.r2c_rows_banks(plan)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("bank_src", ["own", "jax"])
def test_r2c_quad_f32_matches_jax(h, w, bank_src):
    _, jbanks, img = _setup(h, w, seed=h + w)
    want = jdense.r2c_quad(jnp.asarray(img), jbanks, HIGHEST)
    tb = _own_banks(h, w) if bank_src == "own" else banks_from_jax(jbanks, "cpu")
    got = dense.r2c_quad(torch.from_numpy(img), tb)
    for name, a, b in zip(("P00", "P01", "P10", "P11"), want, got):
        assert b.dtype == torch.float32 and b.shape == (3, h, w)
        err = np.abs(np.asarray(a) - b.numpy()).max()
        assert err <= F32_TOL, (name, err)


@pytest.mark.parametrize("h,w", SHAPES)
def test_r2c_quad_i16_matches_jax_same_banks(h, w):
    """Q2.14 codec, same bank values on both sides: every stored plane is
    within 1 tick (independent f32 rounding can flip one rounding)."""
    _, jbanks, img = _setup(h, w, seed=3 * h + w)
    want = jdense.r2c_quad(jnp.asarray(img), jbanks, HIGHEST, **_JCODEC)
    got = dense.r2c_quad(torch.from_numpy(img), banks_from_jax(jbanks, "cpu"), **_CODEC)
    for name, a, b in zip(("P00", "P01", "P10", "P11"), want, got):
        assert b.dtype == torch.int16
        d = np.abs(np.asarray(a).astype(np.int32) - b.numpy().astype(np.int32))
        assert d.max() <= 1, (name, d.max())


@pytest.mark.parametrize("h,w", SHAPES)
def test_r2c_quad_i16_matches_jax_own_banks(h, w):
    """Q2.14 codec with the port's own banks.  The stored even-row planes
    are within 1 tick.  The odd-row planes are the y GEMM of those stored
    planes, so each may also carry the GEMM-propagated difference of the
    stored inputs: |dP1x| <= 1 tick + |Ym|^T |dP0x| (in ticks)."""
    _, jbanks, img = _setup(h, w, seed=5 * h + w)
    want = [np.asarray(p).astype(np.int32) for p in
            jdense.r2c_quad(jnp.asarray(img), jbanks, HIGHEST, **_JCODEC)]
    got = [p.numpy().astype(np.int32) for p in
           dense.r2c_quad(torch.from_numpy(img), _own_banks(h, w), **_CODEC)]
    dev = [np.abs(a - b) for a, b in zip(want, got)]
    assert dev[0].max() <= 1 and dev[1].max() <= 1
    absYm = np.abs(np.asarray(jbanks["Ymat_ns"], np.float64)[:h])
    for even, odd in ((0, 2), (1, 3)):
        bound = 1.0 + np.einsum("jm,cjn->cmn", absYm, dev[even].astype(np.float64))
        assert np.all(dev[odd] <= bound + 1e-9), (odd, dev[odd].max())
        assert (dev[odd] > 1).mean() < 1e-3, (odd, (dev[odd] > 1).mean())


def test_r2c_quad_half_planes_from_stored_inputs():
    """In HALF the y GEMM reads the dequantized STORED even-row planes (the
    JAX staging choice): P10 equals store(Ym^T @ load(P00s)) exactly."""
    h, w = 64, 128
    _, _, img = _setup(h, w, seed=9)
    tb = _own_banks(h, w)
    P00s, P01s, P10s, P11s = dense.r2c_quad(torch.from_numpy(img), tb, **_CODEC)
    YmT = tb["Ymat_ns"][:h].T
    f32 = dense.r2c_quad(torch.from_numpy(img), tb)
    corr10 = f32[2] - YmT @ f32[0]  # the rank-r y-Nyquist correction term
    want = cas.to_i16_storage(YmT @ cas.from_i16_storage(P00s) + corr10)
    assert (want.int() - P10s.int()).abs().max() <= 1
    assert P00s.dtype == P01s.dtype == P11s.dtype == torch.int16


def test_i16_codec_matches_jax():
    rng = np.random.default_rng(17)
    v = rng.random((4, 256)).astype(np.float32) * 4.6 - 2.3  # incl. saturation
    v[0, :4] = [0.5 / 16384, 1.5 / 16384, -0.5 / 16384, 2.5 / 16384]  # ties
    got = cas.to_i16_storage(torch.from_numpy(v)).numpy()
    want = np.asarray(jcas.to_i16_storage(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cas.from_i16_storage(torch.from_numpy(got)).numpy(),
        np.asarray(jcas.from_i16_storage(jnp.asarray(want))),
    )


def test_banks_from_jax_maps_keys_and_split():
    _, jbanks, _ = _setup(64, 128, seed=1)
    tb = banks_from_jax(jbanks, "cpu")
    assert set(tb) == {"alpha", "alpha_odd", "Ymat_ns", "Y1n", "beta"}
    assert all(t.dtype == torch.float32 for t in tb.values())
    own = dense.r2c_rows_banks(UpscalePlan(h=64, w=128, upscale=2.0))
    for key in ("alpha", "alpha_odd"):
        hi = np.asarray(jbanks[key + "_hi"]).astype(np.float64)
        lo = np.asarray(jbanks[key + "_lo"]).astype(np.float64)
        np.testing.assert_array_equal(tb[key].numpy().astype(np.float64), hi + lo)
        # the split is within 2^-17 (relative to the bank's scale) of the f64 bank
        assert np.abs(hi + lo - own[key]).max() <= np.abs(own[key]).max() * 2.0 ** -17


def test_half_precision_banks_are_jax_half_banks_minus_int8():
    """The JAX HALF bank set adds the TPU int8 digit banks; the port ports
    none of them and maps the shared keys the same way."""
    jb = mxu_pipeline.make_dense_banks(
        JPlan(h=64, w=128, upscale=2.0, precision=JPrecision.HALF, engine=JEngine.MXU)
    )
    assert "xq_d1" in jb
    assert set(banks_from_jax(jb, "cpu")) == {"alpha", "alpha_odd", "Ymat_ns", "Y1n", "beta"}
