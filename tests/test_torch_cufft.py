"""The cuFFT form of the pre-CAS transform (vkresample_tpu_torch/fft/cufft.py)
and its one-pass store (ops/fft_cuda.py::quad_store), on the CPU with the
plain versions: the form against the fp64 oracle and against the dense
GEMM route, the store against ops/cas.py::to_i16_storage, the route table
of a card row that names the cuFFT tier, and the call counter; on the card
(-m cuda) the store kernel against its plain version and the form against
the dense quad.

Tolerances: uint8 images <= 1 LSB (the port's bar against the oracle);
the store's plain version equals to_i16_storage of the scaled image on
every value (the fold of 2^14 into the factor is exact)."""
import dataclasses

import numpy as np
import pytest
import torch

from vkresample_tpu_torch import Engine, Precision, UpscalePlan
from vkresample_tpu_torch.core import tuning
from vkresample_tpu_torch.fft import cufft, mxu_pipeline
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.fft_cuda import (
    c2r,
    quad_store,
    quad_store_reference,
    spectrum_pad,
    spectrum_pad_reference,
    spectrum_shift,
    spectrum_shift_reference,
    store_factor,
)
from vkresample_tpu_torch.ops.spectrum import assemble_big_spectrum
from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle
from vkresample_tpu_torch.pipeline import upscale as tpipe

FFT_ROW = tuning.DeviceTuning(dense_max=4608, dense_tier="fft")  # the H100's row
GEMM_ROW = tuning.DeviceTuning(dense_max=4608, dense_tier="gemm")  # the same cap, GEMMs
PRECS = [Precision.SINGLE, Precision.HALF]
# (h, w): the 64x128 -> 128x256 frame, a width no multiple of 128, odd w
SIZES = [(64, 128), (32, 96), (30, 50)]
# leading dims of the call: one (h, w, C) frame, a batch, a batch of batches
LEADS = [(), (2,), (2, 2)]


def _fft_plan(h, w, prec, **kw):
    return tuning.with_row(UpscalePlan(h=h, w=w, upscale=2.0, precision=prec, **kw), FFT_ROW)


@pytest.fixture
def fft_row(monkeypatch):
    """Every device takes the H100's row, the pipeline cache cleared around it."""
    monkeypatch.setattr(tuning, "_row", lambda device: FFT_ROW)
    tpipe._build.cache_clear()
    yield
    tpipe._build.cache_clear()


def _frames(lead, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, lead + (h, w, 3), np.uint8)


def _maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


@pytest.mark.parametrize("lead", LEADS, ids=["frame", "batch", "batch2x2"])
@pytest.mark.parametrize("prec", PRECS, ids=["p0", "p2"])
@pytest.mark.parametrize("h,w", SIZES)
def test_fft_form_matches_oracle_and_dense_route(fft_row, h, w, prec, lead):
    """The route a card with the cuFFT row takes, end to end (cuFFT form,
    store, K1's plain version, weave) on every frame of a call with leading
    dims: <= 1 LSB from the fp64 oracle and from the dense GEMM route of
    the same plan on a device without the row."""
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=prec)
    assert mxu_pipeline.bank_set(tuning.plan_for(plan, "cpu")) == "fft"
    frames = _frames(lead, h, w, seed=h + w + len(lead))
    calls = cufft.r2c_quad_fft.calls
    got = tpipe.build_upscale(plan, "cpu")(frames).numpy()
    assert cufft.r2c_quad_fft.calls == calls + 1  # one transform a call, batch or not
    assert got.shape == lead + (plan.H, plan.W, 3) and got.dtype == np.uint8
    dense = tpipe._build(plan, torch.device("cpu"), False, False)(frames).numpy()
    assert _maxdiff(got, dense) <= 1
    for f in np.ndindex(*lead):
        assert _maxdiff(got[f], upscale_oracle(frames[f], plan)) <= 1, f


@pytest.mark.parametrize("prec", PRECS, ids=["p0", "p2"])
@pytest.mark.parametrize("h,w", SIZES)
def test_fft_form_planes_match_dense_quad(h, w, prec):
    """The form's four pre-CAS planes against the dense quad's, in CAS units:
    within 2 Q2.14 ticks at -p 2 (each side rounds once, the dense quad's
    odd rows from its stored even rows), 1e-4 at -p 0 (float32 GEMMs
    against float32 FFTs)."""
    from vkresample_tpu_torch.fft import dense

    plan = _fft_plan(h, w, prec)
    x = torch.from_numpy(_frames((2,), h, w, seed=w)).movedim(-1, -3).contiguous()
    Ps = cufft.r2c_quad_fft(x, plan)
    banks = {k: torch.from_numpy(v) for k, v in mxu_pipeline.make_dense_banks(
        tuning.with_row(plan, GEMM_ROW)).items()}
    codec = dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
    Qs = dense.r2c_quad(x, banks, **(codec if prec is Precision.HALF else {}))
    for p, q in zip(Ps, Qs):
        assert p.dtype == q.dtype == prec.storage_dtype and p.shape == q.shape == (2, 3, h, w)
        if prec is Precision.HALF:
            assert int((p.int() - q.int()).abs().max()) <= 2
        else:
            assert float((p - q).abs().max()) <= 1e-4


@pytest.mark.parametrize("prec", PRECS, ids=["p0", "p2"])
@pytest.mark.parametrize("h,w", [(64, 128), (128, 256)])
def test_fft_form_planes_match_jax_dense_quad(h, w, prec):
    """The form's four pre-CAS planes against the JAX package's
    fft/dense.py::r2c_quad (float32 GEMMs at HIGHEST, its own Q2.14 codec
    at -p 2) on the same frame: within 2 Q2.14 ticks at -p 2, 1e-4 at -p 0
    (float32 FFTs against GEMMs on the JAX bank's bf16 hi|lo split)."""
    import jax
    import jax.numpy as jnp
    from vkresample_tpu.core.config import Engine as JEngine
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.fft import dense as jdense
    from vkresample_tpu.fft import mxu_pipeline as jmxu
    from vkresample_tpu.ops import cas as jcas

    img = np.random.default_rng(h + 2 * w).integers(0, 256, (3, h, w), np.uint8)
    jbanks = jmxu.make_dense_banks(JPlan(h=h, w=w, upscale=2.0, engine=JEngine.MXU))
    jcodec = (dict(store=jcas.to_i16_storage, load=jcas.from_i16_storage)
              if prec is Precision.HALF else {})
    want = jdense.r2c_quad(jnp.asarray(img), jbanks, jax.lax.Precision.HIGHEST, **jcodec)
    got = cufft.r2c_quad_fft(torch.from_numpy(img), _fft_plan(h, w, prec))
    for name, a, b in zip(("P00", "P01", "P10", "P11"), want, got):
        a = np.asarray(a)
        assert b.dtype == prec.storage_dtype and b.shape == a.shape == (3, h, w), name
        if prec is Precision.HALF:
            assert a.dtype == np.int16
            assert int(np.abs(a.astype(np.int32) - b.numpy().astype(np.int32)).max()) <= 2, name
        else:
            assert float(np.abs(a - b.numpy()).max()) <= 1e-4, name


@pytest.mark.parametrize("prec", PRECS, ids=["p0", "p2"])
@pytest.mark.parametrize("h,w", SIZES)
def test_fft_form_matches_jax_upscale(fft_row, h, w, prec):
    """The route a card with the cuFFT row takes, end to end, against the
    JAX package's upscale() of the same frame on the CPU: within 1 LSB."""
    from vkresample_tpu import upscale as jupscale
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan

    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=prec)
    img = _frames((), h, w, seed=3 * h + w)
    calls = cufft.r2c_quad_fft.calls
    got = tpipe.upscale(img, 2.0, plan=plan, device="cpu").numpy()
    assert cufft.r2c_quad_fft.calls == calls + 1
    jplan = JPlan(h=h, w=w, upscale=2.0, precision=JPrecision(int(prec)))
    assert _maxdiff(got, np.asarray(jupscale(img, 2.0, plan=jplan))) <= 1


def test_fft_form_refuses_other_plans():
    for kw in (dict(upscale=3.0), dict(upscale=2.0, r2c=False),
               dict(upscale=2.0, precision=Precision.DOUBLE)):
        plan = UpscalePlan(h=32, w=64, **kw)
        with pytest.raises(ValueError, match="cuFFT form"):
            cufft.r2c_quad_fft(torch.zeros((3, 32, 64), dtype=torch.uint8), plan)


# ---------------------------------------------------------------------------
# the spectrum shift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,u", [(64, 128, 2.0), (30, 50, 2.0), (32, 64, 3.0),
                                   (32, 48, 1.5), (36, 50, 1.0)])
def test_spectrum_shift_places_the_reference_tiers_bins(h, w, u):
    """The shift's plain version holds the kept columns of the reference
    tier's big spectrum (ops/spectrum.py::assemble_big_spectrum) and zeros
    in the band, for u = 2 and for the other r2c geometries it takes; the
    wrapper on the CPU is the plain version and launches nothing."""
    plan = UpscalePlan(h=h, w=w, upscale=u)
    g = torch.Generator().manual_seed(h + w)
    F = torch.complex(torch.randn((2, 3, h, w // 2 + 1), generator=g),
                      torch.randn((2, 3, h, w // 2 + 1), generator=g))
    args = (plan.H, plan.kept_lo_x, plan.kept_lo_y, plan.kept_hi_y)
    want = assemble_big_spectrum(F, plan)[..., :plan.kept_lo_x]
    assert torch.equal(spectrum_shift_reference(F, *args), want)
    before = spectrum_shift.launches
    assert torch.equal(spectrum_shift(F, *args), want)
    assert spectrum_shift.launches == before


@pytest.mark.parametrize("H,kx,wp", [(16, 4, 9), (60, 25, 51), (8, 9, 9), (1, 1, 1)])
def test_spectrum_pad_is_the_c2r_input(H, kx, wp):
    """The pad's plain version: g in the first kx columns with Im of column
    0 zeroed, zeros past kx, row-major; the same on a g stored y innermost
    (as torch.fft leaves the y inverse) and row-major."""
    g = torch.Generator().manual_seed(H + kx)
    x = torch.complex(torch.randn((2, 3, H, kx), generator=g),
                      torch.randn((2, 3, H, kx), generator=g))
    want = torch.zeros((2, 3, H, wp), dtype=torch.complex64)
    want[..., :kx] = x
    want[..., 0] = x[..., 0].real.to(torch.complex64)
    for layout in (x, x.transpose(-1, -2).contiguous().transpose(-1, -2)):
        got = spectrum_pad(layout, wp)
        assert got.is_contiguous() and torch.equal(got, want)
        assert torch.equal(spectrum_pad_reference(layout, wp), want)


def test_c2r_is_the_unnormalized_irfft():
    g = torch.Generator().manual_seed(9)
    P = torch.complex(torch.randn((2, 5, 9), generator=g), torch.randn((2, 5, 9), generator=g))
    assert torch.equal(c2r(P, 16), torch.fft.irfft(P, n=16, norm="forward"))
    with pytest.raises(ValueError):
        c2r(P, 20)  # not W/2 + 1 columns
    with pytest.raises(ValueError):
        c2r(P.transpose(0, 1), 16)


TORCH = "/venv/lib/python3.12/site-packages/torch"
WHEEL = "/venv/lib/python3.12/site-packages/nvidia/cufft/lib/libcufft.so.11"
SYSTEM = "/usr/local/cuda/lib64/libcufft.so.11"


@pytest.mark.parametrize("mapped,want", [
    ([WHEEL, WHEEL, "/venv/lib/libc.so.6"], WHEEL),           # the wheel's, mapped twice
    ([TORCH + "/lib/libcufft.so.11"], TORCH + "/lib/libcufft.so.11"),  # in torch/lib
    ([SYSTEM, WHEEL], WHEEL),                                  # torch's of two
    ([SYSTEM], SYSTEM),                                        # a torch on the system CUDA
    ([SYSTEM, "/opt/other/libcufft.so.10"], None),             # two, neither torch's
    ([TORCH + "/lib/libcufftw.so.11", "/venv/lib/libc.so.6"], None),  # none mapped
], ids=["wheel", "torch-lib", "torch-of-two", "system", "two-foreign", "none"])
def test_pick_cufft_takes_torchs_library(mapped, want):
    """The C2R calls the libcufft torch loaded: the one under torch's
    install, else the only one mapped, else none (on the card a CUDA tensor
    then raises instead of falling back to torch.fft)."""
    from vkresample_tpu_torch.ops.fft_cuda import pick_cufft

    assert pick_cufft(mapped, TORCH) == want


def test_spectrum_shift_checks_its_input():
    F = torch.zeros((3, 8, 5), dtype=torch.complex64)
    with pytest.raises(TypeError):
        spectrum_shift(F.to(torch.complex128), 16, 4, 4, 4)
    with pytest.raises(ValueError):
        spectrum_shift(F, 16, 6, 4, 4)  # more kept columns than the spectrum has
    with pytest.raises(ValueError):
        spectrum_shift(F, 16, 4, 5, 4)  # more kept rows than the spectrum has
    with pytest.raises(ValueError):
        spectrum_shift(F.transpose(-1, -2), 16, 4, 2, 2)
    with pytest.raises(ValueError):
        spectrum_pad(F, 4)  # wider than the padded width
    with pytest.raises(TypeError):
        spectrum_pad(F.real, 8)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

# a value one store maps to each rounding edge: ties to even on both sides,
# just off a tie, 0, the saturation limits and past them
EDGES = [0.5, 1.5, 2.5, -0.5, -1.5, 0.49999997, 0.50000006, 0.0, 32767.0, 32767.5,
         32768.0, -32768.0, -32768.5, -40000.0, 1e9, -1e9]


@pytest.mark.parametrize("scale", [4.0 / 255.0, 4.0 / (255.0 * 128 * 256), 1.0, 2.25 / 255.0])
@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 2, 6, 10), (1, 2, 2), (4, 30, 50)])
def test_store_plain_version_is_to_i16_storage_of_the_scaled_image(shape, scale):
    """Bit-identical to ops/cas.py::to_i16_storage(v * scale), split into
    the parity planes, on random values and on values that land on every
    rounding edge of the folded factor (ties, saturation)."""
    g = torch.Generator().manual_seed(sum(shape))
    v = (torch.rand(shape, generator=g) * 2.4 - 0.6) / scale
    f = store_factor(scale, True)
    edge = torch.tensor(EDGES, dtype=torch.float64) / f
    n = min(v.numel(), edge.numel())
    v.view(-1)[:n] = edge[:n].to(torch.float32)
    want = cas.to_i16_storage(v * np.float32(scale))
    got = quad_store_reference(v, scale, True)
    for (ry, rx), p in zip(((0, 0), (0, 1), (1, 0), (1, 1)), got):
        assert p.dtype == torch.int16 and p.is_contiguous()
        assert torch.equal(p, want[..., ry::2, rx::2]), (ry, rx)
    f32 = quad_store_reference(v, scale, False)
    for (ry, rx), p in zip(((0, 0), (0, 1), (1, 0), (1, 1)), f32):
        assert torch.equal(p, (v * np.float32(scale))[..., ry::2, rx::2])


def test_store_wrapper_checks_and_counts():
    v = torch.rand((3, 8, 12))
    before = quad_store.launches
    planes = quad_store(v, 0.5, True)
    assert quad_store.launches == before  # the CPU takes the plain version
    assert all(torch.equal(p, q) for p, q in zip(planes, quad_store_reference(v, 0.5, True)))
    with pytest.raises(TypeError):
        quad_store(v.double(), 0.5, True)
    with pytest.raises(ValueError):
        quad_store(torch.rand((3, 7, 12)), 0.5, True)
    with pytest.raises(ValueError):
        quad_store(torch.rand((3, 12, 8)).transpose(-1, -2), 0.5, True)


# ---------------------------------------------------------------------------
# the route table under a row that names the cuFFT tier
# ---------------------------------------------------------------------------

# (plan keywords, takes the cuFFT form under the row)
TABLE = [
    (dict(h=64, w=128, upscale=2.0, precision=Precision.HALF), True),
    (dict(h=64, w=128, upscale=2.0, precision=Precision.SINGLE), True),
    (dict(h=32, w=96, upscale=2.0, precision=Precision.HALF), True),     # rows width
    (dict(h=30, w=50, upscale=2.0, precision=Precision.HALF), True),     # odd width
    (dict(h=1024, w=2048, upscale=2.0, precision=Precision.HALF), True),  # the flagship
    (dict(h=1080, w=1920, upscale=2.0, precision=Precision.HALF), True),  # 1080p -> 4K
    (dict(h=1152, w=2304, upscale=2.0, precision=Precision.HALF), True),  # axis 4608, the cap
    (dict(h=64, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU), False),
    (dict(h=64, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.XLA), False),
    (dict(h=64, w=128, upscale=2.0, precision=Precision.DOUBLE), False),  # -p 1
    (dict(h=64, w=128, upscale=2.0, r2c=False, precision=Precision.HALF), False),  # c2c
    (dict(h=32, w=64, upscale=3.0, precision=Precision.HALF), False),    # u = 3
    (dict(h=32, w=48, upscale=1.5, precision=Precision.HALF), False),    # 3/2
    (dict(h=32, w=64, upscale=4.0, precision=Precision.HALF), False),    # u = 4
    (dict(h=2160, w=3840, upscale=2.0, precision=Precision.HALF), False),  # 4K -> 8K, above
]


@pytest.mark.parametrize("kw,takes", TABLE, ids=[str(sorted(k.items())) for k, _ in TABLE])
def test_route_table_under_the_fft_row(kw, takes):
    """Which plans take the form on a card whose row names it; the others
    keep the route they have on a card whose row does not (the bank set,
    the engine, the plane layout); no plan takes it without a row or on
    the CPU."""
    plan = UpscalePlan(**kw)
    fft, gemm = tuning.with_row(plan, FFT_ROW), tuning.with_row(plan, GEMM_ROW)
    assert mxu_pipeline.fft_tier_selected(fft) is takes
    assert not mxu_pipeline.fft_tier_selected(gemm) and not mxu_pipeline.fft_tier_selected(plan)
    assert tuning.plan_for(plan, "cpu") is plan  # the CPU has no row
    if takes:
        assert mxu_pipeline.bank_set(fft) == "fft"
        assert mxu_pipeline.make_dense_banks(fft) is None
        assert tpipe.route_engine(fft) is Engine.MXU
        assert tpipe.make_device_banks(fft, Engine.MXU, "cpu", True) is None
    else:
        assert mxu_pipeline.bank_set(fft) == mxu_pipeline.bank_set(gemm)
        assert tpipe.route_engine(fft) is tpipe.route_engine(gemm)
        assert tpipe.planes_format(fft) == tpipe.planes_format(gemm)


@pytest.mark.parametrize("kw", [k for k, takes in TABLE if takes],
                         ids=[str(sorted(k.items())) for k, takes in TABLE if takes])
def test_planes_format_of_the_fft_form_is_quad(kw):
    """The form's output is K1's four uint8 parity planes, at every width:
    planes_format is "quad" for every plan that takes it, so the CLI's
    parity encoder and the folder path take them as they take the dense
    quad's."""
    plan = tuning.with_row(UpscalePlan(**kw), FFT_ROW)
    assert tpipe.planes_format(plan) == "quad" and tpipe.parity_planes_supported(plan)


def test_parity_planes_out_and_woven_agree(fft_row):
    """planes_out gives K1's four planes, which weave to the woven call's
    image; the planar layout too."""
    plan = UpscalePlan(h=32, w=96, upscale=2.0, precision=Precision.HALF)
    frames = _frames((2,), 32, 96, seed=5)
    planes = tpipe.build_upscale(plan, "cpu", planes_out=True, planar_out=True)(frames)
    woven = tpipe.build_upscale(plan, "cpu", planar_out=True)(frames)
    assert len(planes) == 4 and all(p.shape == (2, 3, 32, 96) for p in planes)
    for (ry, rx), p in zip(((0, 0), (0, 1), (1, 0), (1, 1)), planes):
        assert torch.equal(woven[..., ry::2, rx::2], p)


def test_plan_refuses_an_unknown_tier():
    """The tier is no constructor argument (a caller cannot pick the cuFFT
    form), only a row sets it, and a row's tier is one of the two."""
    with pytest.raises(TypeError, match="dense_tier"):
        UpscalePlan(h=32, w=64, upscale=2.0, dense_tier="fft")
    with pytest.raises(ValueError, match="dense_tier"):
        tuning.with_row(UpscalePlan(h=32, w=64, upscale=2.0),
                        tuning.DeviceTuning(dense_max=4608, dense_tier="cufft"))
    plan = tuning.with_row(UpscalePlan(h=32, w=64, upscale=2.0), FFT_ROW)
    assert (plan.dense_max, plan.dense_tier) == (4608, "fft")
    assert mxu_pipeline.bank_set(plan) == "fft"


def test_no_row_keeps_the_dense_tier():
    """Without a row (the CPU, a card not in the table) the plan keeps the
    dense GEMM quad; a caller's own cap keeps its tier."""
    plan = UpscalePlan(h=64, w=128, upscale=2.0, precision=Precision.HALF)
    assert tuning.plan_for(plan, "cpu").dense_tier == "gemm"
    assert mxu_pipeline.bank_set(tuning.plan_for(plan, "cpu")) == "rows"
    own = dataclasses.replace(plan, dense_max=4608)
    assert mxu_pipeline.bank_set(own) == "rows"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,off", [((3, 64, 128), 0), ((2, 6, 10), 0), ((1, 2, 2), 0),
                                       ((24, 2048, 4096), 0), ((3, 2160, 3840), 0),
                                       ((3, 64, 128), 1), ((2, 30, 50), 0)])
def test_cuda_store_kernel_matches_plain_version(shape, off):
    """On the card: the store kernel equals its plain version on every
    value, int16 and float32, in the 16-byte form and per value (odd
    width, an image one float off a 16-byte boundary), with the rounding
    edges planted; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + off)
    n = int(np.prod(shape))
    scale = 4.0 / 255.0
    buf = (torch.rand(n + off, generator=g, device="cuda") * 2.4 - 0.6) / scale
    v = buf[off:].view(shape)
    edge = torch.tensor(EDGES, dtype=torch.float64, device="cuda") / store_factor(scale, True)
    v.view(-1)[:min(n, len(EDGES))] = edge[:min(n, len(EDGES))].to(torch.float32)
    for i16 in (True, False):
        before = quad_store.launches
        got = quad_store(v, scale, i16)
        torch.cuda.synchronize()
        assert quad_store.launches == before + 1
        want = quad_store_reference(v, scale, i16)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), i16


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,wf,H,kx,klo,khi", [
    (24, 1024, 1025, 2048, 1024, 512, 512),   # the flagship batch of 8
    (3, 1080, 961, 2160, 960, 540, 540),      # 1080p -> 4K
    (2, 30, 26, 60, 25, 15, 15),              # odd width
    (2, 32, 33, 96, 32, 16, 16),              # u = 3's rows
    (1, 1, 1, 1, 1, 1, 0), (2, 37, 300, 37, 257, 19, 18)])
def test_cuda_spectrum_kernels_match_plain_versions(n, h, wf, H, kx, klo, khi):
    """On the card: the shift and pad kernels equal their plain versions on
    every bin, the pad on g stored y innermost and row-major, one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    g = torch.Generator(device="cuda").manual_seed(n + h + wf)
    F = torch.complex(torch.randn((n, h, wf), generator=g, device="cuda"),
                      torch.randn((n, h, wf), generator=g, device="cuda"))
    before = (spectrum_shift.launches, spectrum_pad.launches)
    got = spectrum_shift(F, H, kx, klo, khi)
    assert got.transpose(-1, -2).is_contiguous()
    wp = kx + 7
    pad = spectrum_pad(got, wp)
    pad_rows = spectrum_pad(got.contiguous(), wp)  # a row-major g: copied to the layout first
    torch.cuda.synchronize()
    assert (spectrum_shift.launches, spectrum_pad.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(got, spectrum_shift_reference(F, H, kx, klo, khi))
    want = spectrum_pad_reference(got, wp)
    assert torch.equal(pad, want) and torch.equal(pad_rows, want)


@pytest.mark.cuda
@pytest.mark.parametrize("W,lead", [(4096, (24, 2048)), (3840, (3, 2160)), (256, (2, 3, 128)),
                                    (50, (7,)), (2, (1,))])
def test_cuda_c2r_matches_torch_fft(W, lead):
    """On the card: the direct cuFFT C2R against torch.fft.irfft of the same
    input (cuFFT both), within float32 rounding of the sum, its input
    overwritten only as scratch; one call a launch, plans reused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(W)
    P = torch.complex(torch.randn(lead + (W // 2 + 1,), generator=g, device="cuda"),
                      torch.randn(lead + (W // 2 + 1,), generator=g, device="cuda"))
    P[..., 0].imag.zero_()
    if W % 2 == 0:
        P[..., -1].imag.zero_()
    want = torch.fft.irfft(P, n=W, norm="forward")
    before = c2r.launches
    got = c2r(P.clone(), W)
    again = c2r(P.clone(), W)
    torch.cuda.synchronize()
    assert c2r.launches == before + 2 and torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1024, 2048), (1080, 1920), (64, 128)])
def test_cuda_fft_form_matches_dense_quad(h, w):
    """On the card: the cuFFT route's uint8 planes within 1 LSB of the dense
    GEMM quad's on a batch of 2; one transform, one launch of each of its
    three kernels and one direct C2R a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
    frames = torch.from_numpy(_frames((2,), h, w, seed=h)).cuda()
    fft = tpipe._build(_fft_plan(h, w, Precision.HALF), torch.device("cuda"), True, True)
    gemm = tpipe._build(dataclasses.replace(plan, engine=Engine.MXU), torch.device("cuda"),
                        True, True)
    counters = lambda: (cufft.r2c_quad_fft.calls, spectrum_shift.launches,  # noqa: E731
                        spectrum_pad.launches, c2r.launches, quad_store.launches)
    before = counters()
    a = fft(frames)
    assert counters() == tuple(b + 1 for b in before)
    b = gemm(frames)
    torch.cuda.synchronize()
    assert max(int((p.int() - q.int()).abs().max()) for p, q in zip(a, b)) <= 1


def _two_devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_cuda_c2r_runs_on_its_tensors_device():
    """On two cards: a C2R of a tensor on cuda:1 while cuda:0 is current
    runs on cuda:1 (its plan, workspace and stream), equal to the same
    transform made with cuda:1 current."""
    _two_devices()
    g = torch.Generator(device="cuda:1").manual_seed(11)
    P = torch.complex(torch.randn((6, 2049), generator=g, device="cuda:1"),
                      torch.randn((6, 2049), generator=g, device="cuda:1"))
    P[..., 0].imag.zero_()
    P[..., -1].imag.zero_()
    with torch.cuda.device(0):
        got = c2r(P.clone(), 4096)
        torch.cuda.synchronize(1)
    with torch.cuda.device(1):
        want = c2r(P.clone(), 4096)
        torch.cuda.synchronize(1)
    assert got.device == torch.device("cuda:1") and torch.equal(got, want)
    ref = torch.fft.irfft(P, n=4096, norm="forward")
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6


@pytest.mark.cuda
def test_cuda_dp_fft_form_over_two_devices(fft_row):
    """On two cards: the dp mode's batch split over [cuda:0, cuda:1] runs
    the cuFFT form on each card's share from one thread, within 1 LSB of
    the one-device batch of all the frames; K1 and the form's kernels once
    a device."""
    _two_devices()
    from vkresample_tpu_torch import build_batched_upscale

    plan = UpscalePlan(h=1024, w=2048, upscale=2.0, precision=Precision.HALF)
    frames = torch.from_numpy(_frames((4,), 1024, 2048, seed=4))
    devs = [torch.device("cuda:0"), torch.device("cuda:1")]
    before = (cufft.r2c_quad_fft.calls, quad_store.launches, c2r.launches)
    two = build_batched_upscale(plan, devs, planes_out=True)(frames)
    for d in devs:
        torch.cuda.synchronize(d)
    assert (cufft.r2c_quad_fft.calls, quad_store.launches, c2r.launches) == tuple(
        b + 2 for b in before)
    one = build_batched_upscale(plan, devs[0], planes_out=True)(frames.to(devs[0]))
    for i, planes in enumerate(one):
        got = torch.cat([part[i].to(devs[0]) for part in two])
        assert int((got.int() - planes.int()).abs().max()) <= 1
