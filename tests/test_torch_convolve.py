"""The port's frequency-domain convolution (vkresample_tpu_torch/ops/
convolve.py): the JAX package's tests/test_convolve.py on the CPU, and the
port against the JAX functions on the same numpy-seeded inputs (atol 1e-4)
for every public function and engine, "auto" as the "xla" path, and the
device rule.  The
cuda-marked twins run the same cases on the card against the port's CPU
path, which the CPU cases hold against JAX; JAX is imported only where it
is compared, since the card's machine has none."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops import convolve as conv_mod
from vkresample_tpu_torch.ops.convolve import (
    fft_convolve2d,
    fft_convolve2d_linear,
    fft_matrix_convolve2d,
    gaussian_kernel,
    kernel_spectrum,
)

CPU = {"device": "cpu"}
ATOL = 1e-4


def circ_conv2d(x, k):
    h, w = x.shape
    out = np.zeros_like(x)
    for dy in range(h):
        for dx in range(w):
            if abs(k[dy, dx]) > 0:
                out += k[dy, dx] * np.roll(np.roll(x, dy, 0), dx, 1)
    return out


def _spectrum_ref(x, k):
    return np.real(np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(k.astype(np.float64))))


def test_single_kernel_matches_direct():
    rng = np.random.default_rng(0)
    x = rng.random((16, 24))
    k = np.zeros((16, 24))
    k[0, 0], k[0, 1], k[1, 0], k[15, 23] = 0.5, 0.2, 0.2, 0.1
    got = fft_convolve2d(torch.tensor(x, dtype=torch.float32), k.astype(np.float32), **CPU)
    np.testing.assert_allclose(got.numpy(), circ_conv2d(x, k), atol=1e-4)


def test_multi_kernel_batching():
    rng = np.random.default_rng(1)
    x = rng.random((3, 8, 16)).astype(np.float32)  # batch of 3
    ks = rng.random((4, 8, 16)).astype(np.float32)  # 4 kernels
    got = fft_convolve2d(x, ks, **CPU).numpy()
    assert got.shape == (4, 3, 8, 16)
    for i in range(4):
        for b in range(3):
            want = circ_conv2d(x[b].astype(np.float64), ks[i].astype(np.float64))
            np.testing.assert_allclose(got[i, b], want, atol=1e-3)


def test_matrix_convolution():
    rng = np.random.default_rng(2)
    x = rng.random((3, 8, 8)).astype(np.float32)
    k = rng.random((2, 3, 8, 8)).astype(np.float32)  # 2x3 matrix conv
    got = fft_matrix_convolve2d(x, k, **CPU).numpy()
    assert got.shape == (2, 8, 8)
    for o in range(2):
        want = sum(
            circ_conv2d(x[i].astype(np.float64), k[o, i].astype(np.float64))
            for i in range(3)
        )
        np.testing.assert_allclose(got[o], want, atol=1e-3)
    with pytest.raises(ValueError, match="Cin"):
        fft_matrix_convolve2d(x, k[:, :2], **CPU)


def test_gaussian_kernel_mass_and_blur():
    k = gaussian_kernel(32, 32, 2.0)
    assert abs(k.sum() - 1.0) < 1e-5
    from vkresample_tpu.ops import convolve as jconv

    np.testing.assert_array_equal(k, jconv.gaussian_kernel(32, 32, 2.0))
    rng = np.random.default_rng(3)
    x = rng.random((32, 32)).astype(np.float32)
    y = fft_convolve2d(x, k, **CPU).numpy()
    assert y.std() < x.std()  # blurred
    assert abs(y.mean() - x.mean()) < 1e-4  # mass preserved


def test_engine_routing_and_fallback():
    from vkresample_tpu_torch.ops.convolve import _engine_ok

    assert _engine_ok(16, 24) and _engine_ok(2048, 4096) and _engine_ok(128)
    assert not _engine_ok(131)  # non-7-smooth prime
    assert not _engine_ok(17)  # small prime outside the radix set
    rng = np.random.default_rng(5)
    # non-smooth size: auto runs the xla engine and still matches direct
    x = rng.random((131, 8))
    k = np.zeros((131, 8))
    k[0, 0], k[1, 0], k[130, 7] = 0.6, 0.3, 0.1
    got = fft_convolve2d(x.astype(np.float32), k.astype(np.float32), **CPU).numpy()
    np.testing.assert_allclose(got, circ_conv2d(x, k), atol=1e-4)
    eng, _ = kernel_spectrum(k.astype(np.float32), **CPU)
    assert eng == "xla"
    with pytest.raises(ValueError):
        fft_convolve2d(x.astype(np.float32), k.astype(np.float32), engine="mxu", **CPU)


def test_engine_mxu_matches_xla():
    rng = np.random.default_rng(6)
    x = rng.random((20, 48)).astype(np.float32)
    k = rng.random((20, 48)).astype(np.float32) / 100
    a = fft_convolve2d(x, k, engine="mxu", **CPU).numpy()
    b = fft_convolve2d(x, k, engine="xla", **CPU).numpy()
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_plan_time_kernel_spectrum_reuse():
    rng = np.random.default_rng(7)
    x = rng.random((2, 16, 32)).astype(np.float32)
    k = gaussian_kernel(16, 32, 1.5)
    spec = kernel_spectrum(k, engine="mxu", **CPU)  # auto resolves to xla
    assert spec[0] == "mxu" and isinstance(spec[1], tuple)
    a = fft_convolve2d(x, spec, **CPU).numpy()
    b = fft_convolve2d(x, k, **CPU).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_linear_convolution_spatial_zero_pad():
    """vkFFT spatial zero-pad parity: linear (non-circular) convolution
    matches direct full convolution."""
    rng = np.random.default_rng(8)
    x = rng.random((9, 13)).astype(np.float32)
    k = rng.random((4, 5)).astype(np.float32)
    got = fft_convolve2d_linear(x, k, **CPU).numpy()
    assert got.shape == (12, 17)
    want = np.zeros((12, 17))
    for dy in range(4):
        for dx in range(5):
            want[dy : dy + 9, dx : dx + 13] += k[dy, dx] * x
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_linear_convolution_batched():
    rng = np.random.default_rng(9)
    x = rng.random((2, 8, 8)).astype(np.float32)
    k = rng.random((3, 3)).astype(np.float32)
    got = fft_convolve2d_linear(x, k, **CPU).numpy()
    assert got.shape == (2, 10, 10)
    for b in range(2):
        want = np.zeros((10, 10))
        for dy in range(3):
            for dx in range(3):
                want[dy : dy + 8, dx : dx + 8] += k[dy, dx] * x[b]
        np.testing.assert_allclose(got[b], want, atol=1e-4)


def test_separable_kernel_matches_spectrum_reference():
    """A separable kernel (Gaussian) on the default engine and on the
    explicit xla engine matches the numpy spectrum reference."""
    h, w = 48, 64
    k = gaussian_kernel(h, w, 2.5)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, h, w)).astype(np.float32)
    want = _spectrum_ref(x, k)
    assert np.abs(fft_convolve2d(x, k, **CPU).numpy() - want).max() < 1e-5
    assert np.abs(fft_convolve2d(x, k, engine="xla", **CPU).numpy() - want).max() < 1e-5


def test_integer_kernel_convolves():
    """Integer-dtype kernels convolve and match the spectrum reference;
    the zero kernel convolves to zero."""
    h, w = 32, 48
    k = np.ones((h, w), np.int32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((h, w)).astype(np.float32)
    want = _spectrum_ref(x, k)
    got = fft_convolve2d(x, k, **CPU).numpy()
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
    kz = np.zeros((h, w), np.float32)
    assert np.abs(fft_convolve2d(x, kz, **CPU).numpy()).max() == 0.0


def test_explicit_mxu_engine_keeps_spectrum_path():
    """engine="mxu" matches the spectrum reference on a separable kernel,
    and its non-smooth-size error fires."""
    h, w = 32, 48
    k = gaussian_kernel(h, w, 2.0)
    x = np.random.default_rng(7).standard_normal((h, w)).astype(np.float32)
    got = fft_convolve2d(x, k, engine="mxu", **CPU).numpy()
    assert np.abs(got - _spectrum_ref(x, k)).max() < 1e-5
    # 31 is prime > 7: the explicit mxu engine raises, separable or not
    k31 = gaussian_kernel(31, w, 2.0)
    x31 = np.random.default_rng(9).standard_normal((31, w)).astype(np.float32)
    with pytest.raises(ValueError, match="radix"):
        fft_convolve2d(x31, k31, engine="mxu", **CPU)
    spec = kernel_spectrum(k, engine="mxu", **CPU)
    with pytest.raises(ValueError, match="radix"):
        fft_convolve2d(x31[:, :25], spec, **CPU)


# ---------------------------------------------------------------------------
# the port against the JAX functions
# ---------------------------------------------------------------------------


def _inputs(seed=20):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((2, 24, 40)).astype(np.float32),
        "k": (rng.standard_normal((24, 40)) / 30).astype(np.float32),
        "bank": (rng.standard_normal((3, 24, 40)) / 30).astype(np.float32),
        "xm": rng.standard_normal((2, 3, 24, 40)).astype(np.float32),
        "km": (rng.standard_normal((2, 3, 24, 40)) / 30).astype(np.float32),
        "kl": (rng.standard_normal((5, 7)) / 6).astype(np.float32),
        "xs": rng.standard_normal((2, 32, 48)).astype(np.float32),
        "gauss": gaussian_kernel(32, 48, 2.5),
        "box": np.ones((32, 48), np.int32),
        "x131": rng.standard_normal((131, 8)).astype(np.float32),
        "k131": (rng.standard_normal((131, 8)) / 30).astype(np.float32),
    }


def _jconv():
    from vkresample_tpu.ops import convolve as jconv

    return jconv


def _arr(m, a):
    """a as the module's own array type: a JAX array for the JAX package,
    a tensor for the port."""
    if m is conv_mod:
        return torch.from_numpy(np.ascontiguousarray(a))
    import jax.numpy as jnp

    return jnp.asarray(a)


def _spec_case(engine):
    def run(m, kw, d):
        return m.fft_convolve2d(d["x"], m.kernel_spectrum(d["k"], engine=engine, **kw), **kw)
    return run


# name -> call(module, device keywords, inputs); every public function and engine
JAX_CASES = {
    **{f"single {e}": (lambda e: lambda m, kw, d: m.fft_convolve2d(
        d["x"], d["k"], engine=e, **kw))(e) for e in ("auto", "mxu", "xla")},
    **{f"bank {e}": (lambda e: lambda m, kw, d: m.fft_convolve2d(
        d["x"], d["bank"], engine=e, **kw))(e) for e in ("auto", "mxu", "xla")},
    **{f"matrix {e}": (lambda e: lambda m, kw, d: m.fft_matrix_convolve2d(
        d["xm"], d["km"], engine=e, **kw))(e) for e in ("auto", "mxu", "xla")},
    **{f"linear {e}": (lambda e: lambda m, kw, d: m.fft_convolve2d_linear(
        d["x"], d["kl"], engine=e, **kw))(e) for e in ("auto", "mxu", "xla")},
    "spectrum mxu": _spec_case("mxu"),
    "spectrum xla": _spec_case("xla"),
    "spectrum auto": _spec_case("auto"),
    "separable gaussian auto": lambda m, kw, d: m.fft_convolve2d(d["xs"], d["gauss"], **kw),
    "separable gaussian array kernel": lambda m, kw, d: m.fft_convolve2d(
        d["xs"], _arr(m, d["gauss"]), **kw),
    "separable int box auto": lambda m, kw, d: m.fft_convolve2d(d["xs"], d["box"], **kw) / 1536,
    "non-smooth auto": lambda m, kw, d: m.fft_convolve2d(d["x131"], d["k131"], **kw),
    "non-smooth xla": lambda m, kw, d: m.fft_convolve2d(d["x131"], d["k131"], engine="xla",
                                                        **kw),
}


def _check_case(case, device, ref="jax"):
    """The port on `device` against the JAX package ("jax") or against the
    port on the CPU ("cpu")."""
    d = _inputs()
    if ref == "jax":
        want = np.asarray(JAX_CASES[case](_jconv(), {}, d))
    else:
        want = JAX_CASES[case](conv_mod, CPU, d).numpy()
    got = JAX_CASES[case](conv_mod, {"device": device}, d)
    assert isinstance(got, torch.Tensor) and got.device.type == torch.device(device).type
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_matches_jax(case):
    _check_case(case, "cpu")


# name -> call(engine, inputs): "auto" must give the "xla" path's output
# bit for bit, for the kernels the JAX package routes elsewhere on "auto"
# (separable ones of the frame's size) as for the rest
AUTO_CASES = {
    "gaussian": lambda e, d: fft_convolve2d(d["xs"], d["gauss"], engine=e, **CPU),
    "gaussian tensor": lambda e, d: fft_convolve2d(
        d["xs"], torch.from_numpy(d["gauss"]), engine=e, **CPU),
    "int box": lambda e, d: fft_convolve2d(d["xs"], d["box"], engine=e, **CPU),
    "linear gaussian": lambda e, d: fft_convolve2d_linear(
        d["xs"][..., :26, :40], gaussian_kernel(7, 9, 1.0), engine=e, **CPU),
    "non-separable": lambda e, d: fft_convolve2d(d["x"], d["k"], engine=e, **CPU),
    "bank": lambda e, d: fft_convolve2d(d["x"], d["bank"], engine=e, **CPU),
    "matrix": lambda e, d: fft_matrix_convolve2d(d["xm"], d["km"], engine=e, **CPU),
    "spectrum": lambda e, d: fft_convolve2d(
        d["xs"], kernel_spectrum(d["gauss"], engine=e, **CPU), **CPU),
    "gaussian, 24 rows": lambda e, d: fft_convolve2d(
        d["x"], gaussian_kernel(24, 40, 2.0), engine=e, **CPU),
    "non-smooth": lambda e, d: fft_convolve2d(d["x131"], d["k131"], engine=e, **CPU),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_is_the_xla_path(case):
    """engine="auto" resolves to "xla" for every kernel: the same output
    bit for bit, and kernel_spectrum tags its spectrum "xla"."""
    d = _inputs()
    assert torch.equal(AUTO_CASES[case]("auto", d), AUTO_CASES[case]("xla", d))
    assert kernel_spectrum(d["gauss"], **CPU)[0] == "xla"


ENTRY_POINTS = {
    "fft_convolve2d": lambda **kw: fft_convolve2d(np.ones((8, 8), np.float32),
                                                  np.eye(8, dtype=np.float32), **kw),
    "fft_matrix_convolve2d": lambda **kw: fft_matrix_convolve2d(
        np.ones((2, 8, 8), np.float32), np.ones((2, 2, 8, 8), np.float32), **kw),
    "fft_convolve2d_linear": lambda **kw: fft_convolve2d_linear(
        np.ones((8, 8), np.float32), np.ones((3, 3), np.float32), **kw),
    "kernel_spectrum": lambda **kw: kernel_spectrum(np.ones((8, 8), np.float32), **kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_cuda_unless_cpu(monkeypatch, name):
    """Without a CUDA device the entry points raise unless the caller asks
    for the CPU: the port never falls back by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
    assert ENTRY_POINTS[name](device="cpu") is not None


# ---------------------------------------------------------------------------
# the same cases on the card, against the port's CPU path
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_cuda_matches_jax(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_case(case, "cuda", ref="cpu")
