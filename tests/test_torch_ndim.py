"""The port's N-D FFT (vkresample_tpu_torch/fft/ndim.py): the JAX
package's tests/test_ndim.py against numpy, and the port against the JAX
functions on the same numpy-seeded inputs (atol 1e-4, values of order 1,
axes <= 64), their errors included.  The cuda-marked twins run the same
cases on the card against the port's CPU path, which the CPU cases hold
against JAX; JAX is imported only where it is compared, since the card's
machine has none."""
import functools
import types

import numpy as np
import pytest
import torch

from vkresample_tpu_torch.fft import ndim as tndim
from vkresample_tpu_torch.fft.ndim import fftn, irfftn, rfftn

ATOL = 1e-4


def _cp(z):
    return (torch.from_numpy(np.ascontiguousarray(z.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(z.imag, np.float32)))


def _np(p):
    return p[0].cpu().numpy() + 1j * p[1].cpu().numpy()


def test_fft3d_vs_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 10, 16)) + 1j * rng.normal(size=(2, 12, 10, 16))
    got = _np(fftn(_cp(x), axes=(-3, -2, -1), device="cpu"))
    want = np.fft.fftn(x, axes=(-3, -2, -1))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_ifft3d_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 8, 10)) + 1j * rng.normal(size=(6, 8, 10))
    F = fftn(_cp(x), axes=(0, 1, 2), device="cpu")
    back = _np(fftn(F, axes=(0, 1, 2), inverse=True, device="cpu"))
    assert np.max(np.abs(back - x)) < 1e-4


def test_rfftn_irfftn_roundtrip_3d():
    rng = np.random.default_rng(2)
    x = rng.random((4, 8, 12)).astype(np.float32)
    F = rfftn(x, axes=(-3, -2, -1), device="cpu")
    want = np.fft.rfftn(x, axes=(-3, -2, -1))
    got = _np(F)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5
    back = irfftn(F, s=x.shape, axes=(-3, -2, -1), device="cpu").numpy()
    assert np.max(np.abs(back - x)) < 1e-5


def test_rfftn_irfftn_roundtrip_odd_last_axis():
    """Odd w has no Nyquist bin: every shape-parity combination of the
    penultimate dim round-trips to the input's shape."""
    rng = np.random.default_rng(5)
    for shape in [(4, 8, 15), (4, 7, 15), (6, 9), (2, 5, 8, 15)]:
        x = rng.random(shape).astype(np.float32)
        axes = tuple(range(-min(3, x.ndim), 0))
        F = rfftn(x, axes=axes, device="cpu")
        want = np.fft.rfftn(x, axes=axes)
        got = _np(F)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5, shape
        back = irfftn(F, s=x.shape, axes=axes, device="cpu").numpy()
        assert back.shape == x.shape, (shape, back.shape)
        assert np.max(np.abs(back - x)) < 1e-5, shape


def test_fft1d_axis0():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(24, 5)) + 1j * rng.normal(size=(24, 5))
    got = _np(fftn(_cp(x), axes=(0,), device="cpu"))
    want = np.fft.fft(x, axis=0)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


# ---------------------------------------------------------------------------
# the port against the JAX functions
# ---------------------------------------------------------------------------

# name -> (shape, axes, inverse, normalize) of a complex fftn case
FFTN_CASES = {
    "2d": ((3, 16, 24), (-2, -1), False, None),
    "3d": ((6, 8, 10), (-3, -2, -1), False, None),
    "axis0": ((24, 5), (0,), False, None),
    "middle axis": ((4, 12, 6), (1,), False, None),
    "inverse 2d": ((3, 16, 24), (-2, -1), True, None),
    "inverse 3d": ((6, 8, 10), (0, 1, 2), True, None),
    "inverse unnormalized": ((6, 8, 10), (-3, -2, -1), True, False),
    "forward normalize=True": ((8, 12), (-2, -1), False, True),
    "repeated axis": ((6, 8), (-1, 1), False, None),
}

# shapes of the rfftn -> irfftn round trips, over every axis
RFFT_SHAPES = [(4, 8, 12), (6, 10), (4, 8, 15), (4, 7, 15), (2, 5, 8, 15), (3, 64)]


def _seeded_pair(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(2))


def _reference(ref):
    """The functions a case is held against: the JAX package's ("jax"),
    or the port's on the CPU ("cpu")."""
    if ref == "jax":
        from vkresample_tpu.fft import ndim as jndim

        return jndim
    return types.SimpleNamespace(**{name: functools.partial(getattr(tndim, name), device="cpu")
                                    for name in ("fftn", "rfftn", "irfftn")})


def _np_of(v):
    if isinstance(v, tuple):
        return tuple(_np_of(a) for a in v)
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _check_fftn(case, device, ref="jax"):
    shape, axes, inverse, normalize = FFTN_CASES[case]
    n = int(np.prod([shape[a] for a in axes]))
    # forward outputs of order 1: the inputs scaled by 1/sqrt(N)
    x = _seeded_pair(shape, 10, 1.0 if inverse and normalize is not False else n ** -0.5)
    want = _np_of(_reference(ref).fftn(x, axes=axes, inverse=inverse, normalize=normalize))
    got = fftn(x, axes=axes, inverse=inverse, normalize=normalize, device=device)
    for g, w in zip(got, want):
        assert g.device.type == torch.device(device).type
        np.testing.assert_allclose(g.cpu().numpy(), w, atol=ATOL)


def _check_rfft_roundtrip(shape, device, ref="jax"):
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    axes = tuple(range(-x.ndim, 0))
    scale = float(np.prod(shape)) ** -0.5
    R = _reference(ref)
    Fr = R.rfftn(x * scale, axes=axes)
    F = rfftn(x * scale, axes=axes, device=device)
    for g, w in zip(F, _np_of(Fr)):
        np.testing.assert_allclose(g.cpu().numpy(), w, atol=ATOL)
    back = irfftn(F, s=x.shape, axes=axes, device=device).cpu().numpy() / scale
    want = _np_of(R.irfftn(Fr, s=x.shape, axes=axes)) / scale
    assert back.shape == want.shape == x.shape
    np.testing.assert_allclose(back, want, atol=ATOL)
    np.testing.assert_allclose(back, x, atol=ATOL)


def _check_non_hermitian(shape, w, device, ref="jax"):
    """A half spectrum with nonzero Im(DC) and, at even w, Im(Nyquist):
    both are dropped after the complex inverse over the other axes, as the
    JAX package drops them."""
    X = _seeded_pair(shape, 12)
    assert np.abs(X[1][..., 0]).max() > 0.1 and np.abs(X[1][..., -1]).max() > 0.1
    axes = tuple(range(-len(shape), 0))
    s = shape[:-1] + (w,)
    want = _np_of(_reference(ref).irfftn(X, s=s, axes=axes))
    got = irfftn(X, s=s, axes=axes, device=device).cpu().numpy()
    assert got.shape == want.shape == s
    np.testing.assert_allclose(got, want, atol=ATOL)


# (half-spectrum shape, output width): even widths with a Nyquist bin, odd
# widths without, even and odd row counts (the JAX package's packed and
# general C2R paths)
NON_HERMITIAN = [((6, 8, 5), 8), ((6, 7, 8), 14), ((6, 8, 5), 9), ((5, 9, 8), 15), ((4, 8), 14)]


@pytest.mark.parametrize("case", list(FFTN_CASES))
def test_fftn_matches_jax(case):
    _check_fftn(case, "cpu")


@pytest.mark.parametrize("shape", RFFT_SHAPES, ids=str)
def test_rfftn_irfftn_match_jax(shape):
    _check_rfft_roundtrip(shape, "cpu")


@pytest.mark.parametrize("shape,w", NON_HERMITIAN, ids=str)
def test_irfftn_non_hermitian_half_spectrum_matches_jax(shape, w):
    _check_non_hermitian(shape, w, "cpu")


# name -> call taking the module (JAX's or the port's) and its device keywords
ERROR_CASES = {
    "fftn 131": lambda m, kw: m.fftn(_seeded_pair((131, 4), 0), axes=(0,), **kw),
    "rfftn 131": lambda m, kw: m.rfftn(np.zeros((4, 131), np.float32), **kw),
    "irfftn 131 rows": lambda m, kw: m.irfftn(_seeded_pair((131, 5), 0), s=(131, 8), **kw),
    "irfftn width 131": lambda m, kw: m.irfftn(_seeded_pair((4, 66), 0), s=(4, 131), **kw),
    "rfftn real axis not last": lambda m, kw: m.rfftn(np.zeros((4, 8), np.float32),
                                                       axes=(-1, -2), **kw),
    "max_factor below a prime": lambda m, kw: m.fftn(_seeded_pair((4, 14), 0), axes=(-1,),
                                                     max_factor=5, **kw),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_errors_match_jax(case):
    call = ERROR_CASES[case]
    with pytest.raises(ValueError) as want:
        call(_reference("jax"), {})
    with pytest.raises(ValueError) as got:
        call(tndim, {"device": "cpu"})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn", ["fftn", "rfftn", "irfftn"])
def test_entry_points_need_cuda_unless_cpu(monkeypatch, fn):
    """Without a CUDA device the entry points raise unless the caller asks
    for the CPU: the port never falls back by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 8), np.float32)
    call = {"fftn": lambda **kw: fftn((x, x), **kw),
            "rfftn": lambda **kw: rfftn(x, **kw),
            "irfftn": lambda **kw: irfftn((x[:, :5], x[:, :5]), s=(4, 8), **kw)}[fn]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert call(device="cpu") is not None


# ---------------------------------------------------------------------------
# the same cases on the card, against the port's CPU path
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FFTN_CASES))
def test_cuda_fftn_matches_jax(cuda, case):
    _check_fftn(case, cuda, ref="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RFFT_SHAPES, ids=str)
def test_cuda_rfftn_irfftn_match_jax(cuda, shape):
    _check_rfft_roundtrip(shape, cuda, ref="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,w", NON_HERMITIAN, ids=str)
def test_cuda_irfftn_non_hermitian_half_spectrum_matches_jax(cuda, shape, w):
    _check_non_hermitian(shape, w, cuda, ref="cpu")
