"""Port plan layer and fp64 oracle against the JAX package (CPU).

The port's UpscalePlan must equal vkresample_tpu.core.plan's field for
field, reject the same geometries, and its oracle must equal the JAX
package's oracle bit for bit."""
import dataclasses

import numpy as np
import pytest

from vkresample_tpu.core import plan as jplan_mod
from vkresample_tpu.core import smooth as jsmooth
from vkresample_tpu.core.config import Engine as JEngine
from vkresample_tpu.core.config import Precision as JPrecision
from vkresample_tpu.oracle import numpy_ref as joracle
from vkresample_tpu_torch.core import plan as tplan_mod
from vkresample_tpu_torch.core import smooth as tsmooth
from vkresample_tpu_torch.core.config import (
    Engine,
    Precision,
    ResampleConfig,
    default_output_name,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle

_UPSCALES = [1.0, 2.0, 3.0, 1.5, 1.3333334]
_SIZES = [(64, 128), (48, 96), (37, 50), (45, 64), (128, 256), (33, 35)]
_PROPS = ("kept_lo_y", "kept_hi_y", "kept_lo_x", "kept_hi_x", "mxu_mode",
          "mxu_supported")


def _plain(v):
    return v.value if hasattr(v, "value") else v


def _make(mod, P, E, h, w, u, r2c, prec, engine=None):
    try:
        return mod.UpscalePlan(
            h=h, w=w, upscale=u, r2c=r2c, precision=P(prec),
            engine=E(engine or "auto"),
        ), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("r2c", [True, False])
@pytest.mark.parametrize("u", _UPSCALES)
def test_plan_matches_jax_field_by_field(u, r2c):
    for h, w in _SIZES:
        for prec in (0, 1, 2):
            tp, terr = _make(tplan_mod, Precision, Engine, h, w, u, r2c, prec)
            jp, jerr = _make(jplan_mod, JPrecision, JEngine, h, w, u, r2c, prec)
            # the same geometries are rejected, with the same message
            assert terr == jerr, (h, w, u, r2c)
            if tp is None:
                continue
            for f in dataclasses.fields(jp):
                assert _plain(getattr(tp, f.name)) == _plain(getattr(jp, f.name)), (
                    f.name, h, w, u, r2c)
            for prop in _PROPS:
                assert getattr(tp, prop) == getattr(jp, prop), (prop, h, w, u)
            assert tp.resolve_engine().value == jp.resolve_engine().value


def test_plan_rejections_raise_value_error():
    # odd h at u=2: the reference would read uninitialized spectrum rows
    for mod in (tplan_mod, jplan_mod):
        with pytest.raises(ValueError, match="unsupported geometry"):
            mod.UpscalePlan(h=5, w=64, upscale=2.0)
        with pytest.raises(ValueError, match="upscale must be >= 1.0"):
            mod.UpscalePlan(h=64, w=64, upscale=0.5)


def test_plan_big_modes_and_engine_errors_match_jax():
    cases = [(4096, 8192, 2.0), (8192, 8192, 1.5), (4100, 8190, 2.0), (5000, 4097, 2.0)]
    for h, w, u in cases:
        tp = tplan_mod.UpscalePlan(h=h, w=w, upscale=u)
        jp = jplan_mod.UpscalePlan(h=h, w=w, upscale=u)
        assert tp.mxu_mode == jp.mxu_mode, (h, w, u)
    tp = tplan_mod.UpscalePlan(h=5000, w=4097, upscale=2.0, engine=Engine.MXU)
    jp = jplan_mod.UpscalePlan(h=5000, w=4097, upscale=2.0, engine=JEngine.MXU)
    for p in (tp, jp):
        with pytest.raises(ValueError, match="MXU engine requires 7-smooth"):
            p.resolve_engine()


def test_output_dims_band_float_and_7smooth_match_jax():
    for h, w, u in [(1080, 1920, 1.5), (128, 256, 1.3333334), (7, 9, 3.0)]:
        assert tplan_mod.output_dims(h, w, u) == jplan_mod.output_dims(h, w, u)
        for n in (h, w, 2 * h):
            assert tplan_mod._band_float(n, u) == jplan_mod._band_float(n, u)
    for n in (1, 2, 11, 1024, 1920, 2310, 8192, 10080, 4097):
        assert tsmooth.is_7smooth(n) == jsmooth.is_7smooth(n)
        if jsmooth.is_7smooth(n):
            assert tsmooth.factorize_7smooth(n) == jsmooth.factorize_7smooth(n)
            assert tsmooth.plan_factors(n) == jsmooth.plan_factors(n)
    with pytest.raises(ValueError, match="not 7-smooth"):
        tsmooth.factorize_7smooth(22)
    p = tplan_mod.UpscalePlan(h=64, w=64, upscale=1.3333334)
    with pytest.raises(ValueError, match="not decomposable"):
        p.validate_7smooth()


def test_config_matches_jax_defaults():
    import torch

    from vkresample_tpu.core.config import ResampleConfig as JConfig
    from vkresample_tpu.core.config import default_output_name as jname

    t, j = ResampleConfig(), JConfig()
    for f in dataclasses.fields(j):
        assert _plain(getattr(t, f.name)) == _plain(getattr(j, f.name)), f.name
    assert default_output_name(256, 1.5) == jname(256, 1.5)
    assert Precision.HALF.storage_dtype is torch.int16
    assert Precision.SINGLE.storage_dtype is torch.float32
    assert Precision.DOUBLE.compute_dtype is torch.float64
    assert Precision.HALF.compute_dtype is torch.float32


@pytest.mark.parametrize(
    "h,w,u,r2c",
    [(64, 128, 2.0, True), (48, 96, 1.5, True), (37, 50, 1.0, True),
     (32, 64, 3.0, False), (48, 64, 1.3333334, True)],
)
def test_oracle_equals_jax_oracle_exactly(h, w, u, r2c):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    tp = tplan_mod.UpscalePlan(h=h, w=w, upscale=u, r2c=r2c)
    jp = jplan_mod.UpscalePlan(h=h, w=w, upscale=u, r2c=r2c)
    np.testing.assert_array_equal(
        toracle.upscale_oracle(img, tp), joracle.upscale_oracle(img, jp)
    )
