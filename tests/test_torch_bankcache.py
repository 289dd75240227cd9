"""The port's disk bank cache (core/bankcache.py), after the JAX package's
tests/test_bankcache.py: round trip, hit and miss, key separation, corrupt
entries, the disable switch, the small-geometry gate, make_dense_banks
through the cache, and the port's entries kept apart from the JAX
package's."""
import numpy as np
import pytest

from vkresample_tpu_torch.core import bankcache
from vkresample_tpu_torch.core.config import Engine, Precision
from vkresample_tpu_torch.core.plan import UpscalePlan


@pytest.fixture()
def cachedir(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(bankcache, "MIN_CACHED_DIM", 0)
    return tmp_path / "torch"


def _plan(h=32, w=64, **kw):
    return UpscalePlan(h=h, w=w, upscale=kw.pop("upscale", 2.0),
                       precision=kw.pop("precision", Precision.HALF), engine=Engine.MXU, **kw)


SAMPLE = {
    "f32": np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4),
    "f64": np.linspace(-1, 1, 8, dtype=np.float64),
    "i8": np.arange(-8, 8, dtype=np.int8).reshape(4, 4),
    "scalar": np.asarray(0.25, np.float64),
}


def test_round_trip_and_hit(cachedir):
    calls = []

    def build():
        calls.append(1)
        return dict(SAMPLE)

    got1 = bankcache.get_or_build("t", _plan(), "float32", build)
    got2 = bankcache.get_or_build("t", _plan(), "float32", build)
    assert len(calls) == 1  # the second call is served from disk
    assert len(list(cachedir.glob("t-*.npz"))) == 1
    for k, v in SAMPLE.items():
        for got in (got1, got2):
            a = np.asarray(got[k])
            assert a.dtype == v.dtype and a.shape == v.shape and np.array_equal(a, v), k


def test_key_separates_geometry_tag_dtype_and_mode(cachedir):
    calls = []

    def build():
        calls.append(1)
        return {"x": np.zeros(2, np.float32)}

    for tag, plan, dtype in [
        ("t", _plan(32, 64), "float32"),
        ("t", _plan(32, 128), "float32"),
        ("u", _plan(32, 64), "float32"),
        ("t", _plan(32, 64), "float64"),
        ("t", _plan(32, 64, precision=Precision.SINGLE), "float32"),
        ("t", _plan(32, 64, r2c=False), "float32"),
        ("t", _plan(32, 64, upscale=3.0), "float32"),
    ]:
        bankcache.get_or_build(tag, plan, dtype, build)
    assert len(calls) == 7  # every variation missed


def test_corrupt_entry_rebuilds(cachedir):
    def build():
        return {"x": np.arange(4, dtype=np.float32)}

    bankcache.get_or_build("t", _plan(), "float32", build)
    (entry,) = cachedir.glob("t-*.npz")
    entry.write_bytes(b"not a zip")
    got = bankcache.get_or_build("t", _plan(), "float32", build)
    assert np.array_equal(got["x"], np.arange(4, dtype=np.float32))
    # and the entry was written anew
    assert np.array_equal(bankcache._load(str(entry))["x"], np.arange(4, dtype=np.float32))


def test_disable_env(cachedir, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_NO_BANK_CACHE", "1")
    bankcache.get_or_build("t", _plan(), "float32", lambda: {"x": np.zeros(1, np.float32)})
    assert not list(cachedir.parent.rglob("*.npz"))


def test_small_geometry_skips_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))
    # MIN_CACHED_DIM untouched (4096): a 32x64 plan must not hit the disk
    bankcache.get_or_build("t", _plan(), "float32", lambda: {"x": np.zeros(1, np.float32)})
    assert not list(tmp_path.rglob("*.npz"))


def test_default_dir_is_inside_the_package_build(monkeypatch):
    """Without VKRESAMPLE_CACHE_DIR the entries go to the package's build
    directory (gitignored), never outside the checkout."""
    import os

    import vkresample_tpu_torch

    monkeypatch.delenv("VKRESAMPLE_CACHE_DIR", raising=False)
    pkg = os.path.dirname(os.path.abspath(vkresample_tpu_torch.__file__))
    assert bankcache.cache_dir() == os.path.join(pkg, "build", "bankcache")


@pytest.mark.parametrize("kw,tag", [
    (dict(h=32, w=128, upscale=2.0), "rows"),
    (dict(h=32, w=128, upscale=2.0, precision=Precision.DOUBLE), "staged64"),
    (dict(h=36, w=96, upscale=3.0, r2c=False), "c2cgrid"),
])
def test_make_dense_banks_via_cache(cachedir, kw, tag):
    """make_dense_banks round-trips real bank sets through the cache with
    every leaf equal, under the tag of its bank set."""
    from vkresample_tpu_torch.fft import mxu_pipeline

    plan = UpscalePlan(**kw)
    assert mxu_pipeline.bank_set(plan) == tag
    fresh = mxu_pipeline.make_dense_banks(plan)
    cached = mxu_pipeline.make_dense_banks(plan)
    assert list(cachedir.glob(f"{tag}-*.npz"))
    assert set(fresh) == set(cached)
    for k in fresh:
        a, b = np.asarray(fresh[k]), np.asarray(cached[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def test_entries_apart_from_the_jax_package(cachedir):
    """Under one VKRESAMPLE_CACHE_DIR the JAX package's entries sit in the
    directory and the port's in its torch/ subdirectory, each served its
    own bank set."""
    from vkresample_tpu.core import bankcache as jbankcache
    from vkresample_tpu.core.plan import UpscalePlan as JPlan

    jbankcache.MIN_CACHED_DIM, saved = 0, jbankcache.MIN_CACHED_DIM
    try:
        jbankcache.get_or_build("staged", JPlan(h=32, w=64, upscale=2.0), "float32",
                                lambda: {"x": np.zeros(1, np.float32)})
        bankcache.get_or_build("staged", _plan(32, 64, precision=Precision.SINGLE), "float32",
                               lambda: {"x": np.ones(1, np.float32)})
        got = bankcache.get_or_build("staged", _plan(32, 64, precision=Precision.SINGLE),
                                     "float32", lambda: {"x": np.full(1, 2, np.float32)})
    finally:
        jbankcache.MIN_CACHED_DIM = saved
    assert list(cachedir.parent.glob("staged-*.npz")) and list(cachedir.glob("staged-*.npz"))
    assert got["x"][0] == 1.0
