"""The port's staged r2c transforms (CPU) against the JAX package's
vkresample_tpu/fft/staged.py on the CPU: the kernel columns, the staged
quad and grid bank sets (integer and p/q, float32 and float64) and the
transforms' planes, at the cases of JAX's tests/test_staged.py.

Tolerances, by what is compared:
- banks: equal element for element (the same numpy arithmetic); the port
  drops only the JAX experimental codecs' qb/dc0 entries;
- planes in float32: <= 1e-5 in CAS units (float32 stage sums in another
  order);
- planes in -p 2 (int16 Q2.14): <= 2 ticks (a tick flips where the f32
  values straddle a rounding edge);
- planes in float64: <= 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.core.plan import UpscalePlan as JPlan
from vkresample_tpu.fft import mxu_pipeline as jmxu
from vkresample_tpu.fft import staged as jstaged
from vkresample_tpu.ops import cas as jcas
from vkresample_tpu_torch import Precision, UpscalePlan
from vkresample_tpu_torch.fft import mxu_pipeline, staged
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.oracle import numpy_ref as toracle

HIGHEST = jax.lax.Precision.HIGHEST
_CODEC = dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
_JCODEC = dict(store=jcas.to_i16_storage, load=jcas.from_i16_storage)
TOL = {"f32": 1e-5, "i16": 2, "f64": 1e-12}

# (h, w): staged quad geometries: 128-aligned, the x_split_prefer padding
# branch (w = 120, 360), and h = 882 (y n1 = 21, odd: the post path)
QUAD_GEOMS = [(32, 128), (64, 256), (96, 120), (882, 384), (48, 360)]
# (h, w, u): grid geometries, integer (h = 882 odd n1) and p/q (q = 2, 3,
# 4, 5; w/q not a multiple of 128 in (96, 360))
GRID_GEOMS = [(64, 128, 3.0), (32, 128, 4.0), (48, 360, 3.0), (882, 128, 3.0),
              (64, 256, 1.5), (32, 512, 1.25), (64, 256, 2.5), (96, 384, 1.3333334),
              (90, 640, 1.2), (96, 360, 1.5)]


def _plans(h, w, u, precision=Precision.HALF, r2c=True):
    return (JPlan(h=h, w=w, upscale=u, precision=JPrecision(int(precision)), r2c=r2c),
            UpscalePlan(h=h, w=w, upscale=u, precision=precision, r2c=r2c))


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (c, h, w), np.uint8)


def _banks_equal(tb, jb):
    assert set(tb) == {k for k in jb if not k.endswith(("_qb", "_dc0"))}
    for key in tb:
        a, b = np.asarray(tb[key]), np.asarray(jb[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key


def _tdev(banks):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in banks.items()}


def _jdev(banks):
    return {k: jnp.asarray(v) for k, v in banks.items()}


def _planes_close(got, want, codec):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.numpy().astype(np.float64)
        b = np.asarray(b).astype(np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL[codec], np.abs(a - b).max()


# ---------------------------------------------------------------------------
# kernel columns and banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", QUAD_GEOMS)
def test_kernels_match_jax(h, w):
    """y_kernel, x_kernels and phase_x_kernels columns equal JAX's."""
    jplan, plan = _plans(h, w, 2.0)
    cy, a0 = staged.y_kernel(h, plan.kept_lo_y, plan.kept_hi_y)
    jcy, ja0 = jstaged.y_kernel(h, jplan.kept_lo_y, jplan.kept_hi_y)
    assert np.array_equal(cy, jcy) and a0 == ja0
    for a, b in zip(staged.x_kernels(w, plan.kept_lo_x), jstaged.x_kernels(w, jplan.kept_lo_x)):
        assert np.array_equal(a, b)
    for rx, u in [(0, 2), (1, 2), (2, 3), (1, 1.5)]:
        for a, b in zip(staged.phase_x_kernels(w, plan.kept_lo_x, rx, u),
                        jstaged.phase_x_kernels(w, jplan.kept_lo_x, rx, u)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("h,w", QUAD_GEOMS)
def test_quad_banks_match_jax(h, w, dtype):
    jplan, plan = _plans(h, w, 2.0)
    assert staged.staged_supported(plan) == jstaged.staged_supported(jplan) is True
    _banks_equal(staged.r2c_quad_staged_banks(plan, dtype),
                 jstaged.r2c_quad_staged_banks(jplan, dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("h,w,u", GRID_GEOMS)
def test_grid_banks_match_jax(h, w, u, dtype):
    jplan, plan = _plans(h, w, u)
    assert staged.grid_params(plan) == jstaged.grid_params(jplan) is not None
    assert staged.frac_params(plan) == jstaged.frac_params(jplan)
    _banks_equal(staged.r2c_grid_staged_banks(plan, dtype),
                 jstaged.r2c_grid_staged_banks(jplan, dtype))


@pytest.mark.parametrize("h,w,u,r2c,tag", [
    (32, 128, 2.0, True, "staged64"), (96, 120, 2.0, True, "staged64"),
    (882, 384, 2.0, True, "staged64"), (36, 96, 3.0, True, "grid64"),
    (64, 256, 1.5, True, "grid64"), (48, 256, 2.0, False, "c2cgrid64"),
    (36, 384, 3.0, False, "c2cgrid64"), (64, 512, 2.75, False, "c2cgrid64"),
])
def test_f64_bank_sets_match_jax(h, w, u, r2c, tag):
    """-p 1 takes the float64 staged bank set JAX's make_dense_banks
    chooses, at every size, equal element for element."""
    jplan, plan = _plans(h, w, u, Precision.DOUBLE, r2c)
    assert mxu_pipeline.bank_set(plan) == tag
    tb = mxu_pipeline.make_dense_banks(plan)
    jb = jmxu.make_dense_banks(jplan, "float64")
    assert all(np.asarray(v).dtype == np.float64 for v in tb.values())
    _banks_equal(tb, jb)


@pytest.mark.parametrize("n,q", [(8640, 1), (8640, 2), (8400, 1), (16384, 1), (10080, 1),
                                 (3840, 1), (2160, 1), (4096, 1), (8192, 2), (17280, 1)])
def test_big_splits_match_jax(n, q):
    """The splits of the big frames' axes equal JAX's (x_split_prefer's
    padding window at 8640, 8400 and 10080; the doubling at 16384)."""
    assert staged.x_split_prefer(q, n=n) == jstaged.x_split_prefer(q, n=n)
    assert staged.split_factors(n, multiple_of=q) == jstaged.split_factors(n, multiple_of=q)


def test_split_of_big_widths():
    assert staged.x_split_prefer(n=8640) == 120
    assert staged.x_split_prefer(n=16384) == 256
    assert staged.x_split_prefer(n=8192) == 128


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["f32", "i16", "f64"])
@pytest.mark.parametrize("h,w", QUAD_GEOMS)
def test_quad_staged_matches_jax(h, w, codec):
    """r2c_quad_staged's four planes against JAX's at HIGHEST: float32,
    with the Q2.14 codec, and float64 banks (fp64 transform)."""
    jplan, plan = _plans(h, w, 2.0)
    dtype = "float64" if codec == "f64" else "float32"
    banks = staged.r2c_quad_staged_banks(plan, dtype)
    x = _img(h, w, seed=h + w, c=2)
    kw, jkw = (_CODEC, _JCODEC) if codec == "i16" else ({}, {})
    got = staged.r2c_quad_staged(torch.from_numpy(x), _tdev(banks), **kw)
    with jax.enable_x64(codec == "f64"):
        want = jstaged.r2c_quad_staged(jnp.asarray(x), _jdev(banks), HIGHEST, **jkw)
        want = [np.asarray(p) for p in want]
    assert got[0].dtype == (torch.int16 if codec == "i16" else getattr(torch, dtype))
    _planes_close(got, want, codec)


@pytest.mark.parametrize("codec", ["f32", "i16", "f64"])
@pytest.mark.parametrize("h,w,u", GRID_GEOMS)
def test_grid_staged_matches_jax(h, w, u, codec):
    """r2c_grid_staged's p^2 planes against JAX's at HIGHEST."""
    jplan, plan = _plans(h, w, u)
    p, q = staged.grid_params(plan)
    dtype = "float64" if codec == "f64" else "float32"
    banks = staged.r2c_grid_staged_banks(plan, dtype)
    assert staged.grid_u(banks) == p
    x = _img(h, w, seed=h + w + p, c=2)
    kw, jkw = (_CODEC, _JCODEC) if codec == "i16" else ({}, {})
    got = staged.r2c_grid_staged(torch.from_numpy(x), _tdev(banks), **kw)
    assert len(got) == p * p and got[0].shape == (2, h // q, w // q)
    with jax.enable_x64(codec == "f64"):
        want = jstaged.r2c_grid_staged(jnp.asarray(x), _jdev(banks), HIGHEST, **jkw)
        want = [np.asarray(p) for p in want]
    _planes_close(got, want, codec)


def _precas_oracle(img, plan):
    """(C, H, W) float64 pre-CAS image of the oracle, in CAS units."""
    u2 = float(np.float32(plan.upscale)) ** 2
    out = []
    for ch in img:
        G = toracle.assemble_big_spectrum(np.fft.rfft2(ch.astype(np.float64) / 255.0), plan)
        out.append(u2 * np.fft.irfft2(G, s=(plan.H, plan.W)))
    return np.stack(out)


@pytest.mark.parametrize("h,w", [(32, 128), (882, 384)])
def test_quad_staged_f64_matches_oracle(h, w):
    """float64 banks give an fp64 transform: the woven quad planes within
    1e-10 of the oracle's pre-CAS image (JAX's staged DOUBLE bar)."""
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.DOUBLE)
    x = _img(h, w, seed=h * w)
    banks = _tdev(staged.r2c_quad_staged_banks(plan, "float64"))
    from vkresample_tpu_torch.ops.weave import weave_grid

    got = weave_grid(staged.r2c_quad_staged(torch.from_numpy(x), banks), 2).numpy()
    assert np.abs(got - _precas_oracle(x, plan)).max() < 1e-10


def test_grid_u2_matches_quad():
    """The u=2 member of the grid family reproduces the quad form."""
    plan = UpscalePlan(h=32, w=128, upscale=2.0)
    x = torch.from_numpy(_img(32, 128, seed=5))
    Pq = staged.r2c_quad_staged(x, _tdev(staged.r2c_quad_staged_banks(plan)))
    Pg = staged.r2c_grid_staged(x, _tdev(staged.r2c_grid_staged_banks(plan)))
    for a, b in zip(Pq, Pg):
        assert (a - b).abs().max() < 1e-5


@pytest.mark.parametrize("n1", [8, 21])
def test_ynyq_rule(n1):
    """ynyq_dc_or_post: even n1 injects through the DC bin ((nd, 1) signs
    (-1)^(q d)), odd n1 adds after the conv over the output rows."""
    yc = torch.tensor(0.5, dtype=torch.float64)
    dc, post = staged.ynyq_dc_or_post(yc, n1, n1, 1, 4 * n1)
    with jax.enable_x64(True):
        jdc, jpost = jstaged.ynyq_dc_or_post(0.5, n1, n1, 1, 4 * n1, np.float64)
        for a, b in ((dc, jdc), (post, jpost)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b))


def test_conv_apply_rows_dc_add():
    """dc_add adds dc_add[d, L] to every output row group, as JAX's."""
    rng = np.random.default_rng(1)
    n, L = 48, 5
    banks = staged.conv_banks(rng.standard_normal(n), "t_", n1=8, dtype="float64")
    x = rng.standard_normal((2, n, L))
    dc = rng.standard_normal((2, 8, L))
    got = staged.conv_apply_rows(torch.from_numpy(x), _tdev(banks), "t_",
                                 dc_add=torch.from_numpy(dc)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jstaged.conv_apply_rows(jnp.asarray(x), _jdev(banks), "t_", HIGHEST,
                                                  dc_add=jnp.asarray(dc)))
    assert np.abs(got - want).max() < 1e-12
