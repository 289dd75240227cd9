"""Port blocked CAS (K6, cas_quantize_blocked: halo rows built outside the
kernel, sqrt/divide blend) and persistent CAS (K7, cas_quantize_mono),
wrappers, halo gather and plain versions, against the JAX package's Pallas
kernels (interpret mode on the CPU), a numpy float32 whole-image CAS, the
woven CAS K3 and the fp64 oracle, alone and on the woven-CAS A/B frame
(dense.r2c_rows without a codec, dense.weave_rows, one CAS).

Tolerances: against the JAX kernels, <= 1 LSB and >= 99.9 % of pixels
identical (the K1-K5 bar; the blends are the same float32 operations, and
every pixel agreed when this was written).  K6 against K3: <= 1 LSB and
>= 99.99 % identical, because the two blends (sqrt(num/den) and
num*rsqrt(num*den)) round apart only where the quotient sits within an ulp
of a truncation boundary.  Against the fp64 oracle, <= 1 LSB (the JAX
package's bar).  The A/B frame against the JAX frame, <= 1 LSB (the x and y
GEMMs sum in another order)."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops.cas_cuda import (
    blocked_halo_rows,
    cas_quantize,
    cas_quantize_blocked,
    cas_quantize_blocked_reference,
    cas_quantize_mono,
    cas_quantize_mono_reference,
    cas_quantize_reference,
    stream_form,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle

MIN_IDENTICAL = 0.999
MIN_IDENTICAL_VS_K3 = 0.9999
ODD_SHAPES = [(2, 37, 201), (1, 1, 1), (3, 16, 5)]


def _pre_cas(shape, seed):
    """Pre-CAS values over [-0.1, 1.2): both clip branches and the
    negative side of |v| are exercised."""
    return np.random.default_rng(seed).random(shape, np.float32) * 1.3 - 0.1


def _agree(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return d.max(), (d == 0).mean()


def _oracle_cas(v):
    v = np.asarray(v, np.float64)
    return np.stack([toracle.quantize_u8(toracle.cas_sharpen(c, 0.2, False)) for c in v])


def _sqrt_cas_np(v, sharpen):
    """Whole-image clamp-to-edge CAS in numpy float32 with the sqrt/divide
    blend, in _cas_blk_kernel's operation order (cas_pallas.py:2378-2424)."""
    f32 = np.float32
    L = np.minimum(np.abs(v), f32(1.0))
    p = np.pad(L, ((0, 0), (1, 1), (1, 1)), mode="edge")
    H, W = v.shape[-2:]
    at = lambda dy, dx: p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]  # noqa: E731
    n, s, w, e, c = at(-1, 0), at(1, 0), at(0, -1), at(0, 1), at(0, 0)
    mn, mx = np.minimum, np.maximum
    min_cross = mn(mn(n, s), mn(c, mn(w, e)))
    max_cross = mx(mx(n, s), mx(c, mx(w, e)))
    min_all = mn(min_cross, mn(mn(at(-1, -1), at(-1, 1)), mn(at(1, -1), at(1, 1))))
    max_all = mx(max_cross, mx(mx(at(-1, -1), at(-1, 1)), mx(at(1, -1), at(1, 1))))
    minlen = f32(0.5) * (min_cross + min_all)
    maxlen = f32(0.5) * (max_cross + max_all)
    a, b, cq, d = minlen, f32(1.0) - minlen, f32(1.0) - maxlen, maxlen
    pred = a * d < cq * b
    with np.errstate(divide="ignore", invalid="ignore"):  # the unselected quotient
        r = np.where(pred, a, cq) / np.where(pred, b, d)
    sc = -f32(sharpen) * np.sqrt(np.maximum(r, f32(0.0)))
    out = (c + sc * ((n + s) + (w + e))) / (f32(1.0) + f32(4.0) * sc)
    return np.clip(out * f32(255.0), 0, 255).astype(np.int32).astype(np.uint8)


# ---------------------------------------------------------------------------
# against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bh", [((2, 48, 256), 16), ((3, 256, 512), 64)])
def test_blocked_plain_matches_jax_kernel(shape, bh):
    """K6's plain version (through the wrapper on CPU tensors) against JAX
    cas_quantize_blocked (interpret); at these shapes JAX runs its Pallas
    kernel (W % 128 == 0, bh >= 8 dividing H), not its XLA fallback."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas_pallas import cas_quantize_blocked as jk6

    v = _pre_cas(shape, seed=sum(shape))
    want = np.asarray(jk6(jnp.asarray(v), 0.2, block_rows=bh, interpret=True))
    got = cas_quantize_blocked(torch.from_numpy(v), 0.2, block_rows=bh)
    assert got.dtype == torch.uint8 and got.shape == shape
    dmax, same = _agree(got.numpy(), want)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("shape,bh", [((2, 128, 256), 32), ((3, 256, 512), 128)])
def test_mono_plain_matches_jax_kernel(shape, bh):
    """K7's plain version (through the wrapper on CPU tensors) against JAX
    cas_quantize_mono (interpret), which runs its kernel at these shapes."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas_pallas import cas_quantize_mono as jk7

    v = _pre_cas(shape, seed=sum(shape) + 1)
    want = np.asarray(jk7(jnp.asarray(v), 0.2, block_rows=bh, interpret=True))
    got = cas_quantize_mono(torch.from_numpy(v), 0.2, block_rows=bh)
    assert got.dtype == torch.uint8 and got.shape == shape
    dmax, same = _agree(got.numpy(), want)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("H", [1, 2, 5, 37, 48, 64])
def test_halo_rows_match_jax_gather(H):
    """blocked_halo_rows against the JAX wrapper's clamped row gather
    (cas_pallas.py:2446-2448) in numpy, with nb = ceil(H/bh) so ragged
    last blocks are included (JAX itself only takes bh dividing H)."""
    v = _pre_cas((2, H, 9), seed=H)
    for bh in sorted({1, 7, 8, 16, H, H + 5}):
        nb = -(-H // bh)
        idx = np.arange(nb)
        want_top = v[:, np.clip(idx * bh - 1, 0, H - 1), :]
        want_bot = v[:, np.clip((idx + 1) * bh, 0, H - 1), :]
        top, bot = blocked_halo_rows(torch.from_numpy(v), bh)
        assert top.shape == bot.shape == (2, nb, 9) and top.is_contiguous()
        np.testing.assert_array_equal(top.numpy(), want_top)
        np.testing.assert_array_equal(bot.numpy(), want_bot)


# ---------------------------------------------------------------------------
# the blocked plain version: bh, halos, K3, the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_blocked_output_does_not_depend_on_bh(shape):
    """The block height cuts the work, not the result: every bh (ragged
    last blocks, bh = 1, bh > H) gives the numpy whole-image sqrt-blend CAS,
    within 1 LSB of the fp64 oracle."""
    v = _pre_cas(shape, seed=3 + sum(shape))
    tv = torch.from_numpy(v)
    H = shape[1]
    want = _sqrt_cas_np(v, 0.2)
    for bh in sorted({1, 7, 16, H, H + 5}):
        got = cas_quantize_blocked_reference(tv, *blocked_halo_rows(tv, bh), bh, 0.2)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"bh={bh}")
    assert _agree(want, _oracle_cas(v))[0] <= 1


def test_blocked_reference_reads_the_given_halo_rows():
    """The plain version takes its block-edge neighbours from top and bot:
    a wrong halo row changes exactly the rows next to it."""
    v = torch.from_numpy(_pre_cas((1, 24, 40), seed=5))
    bh = 8
    top, bot = blocked_halo_rows(v, bh)
    want = cas_quantize_blocked_reference(v, top, bot, bh, 0.2)
    bad_top, bad_bot = top.clone(), bot.clone()
    bad_top[:, 1] = 1.0  # north of row 8
    bad_bot[:, 2] = 0.0  # south of row 23
    got = cas_quantize_blocked_reference(v, bad_top, bad_bot, bh, 0.2)
    changed = (got != want).any(dim=-1)[0].nonzero().flatten().tolist()
    assert changed == [8, 23]


@pytest.mark.parametrize("shape", [(3, 256, 512), (2, 37, 201), (3, 64, 128)])
def test_blocked_plain_is_within_1_lsb_of_woven_plain(shape):
    """K6's sqrt/divide blend against K3's rsqrt blend: <= 1 LSB, rare."""
    v = torch.from_numpy(_pre_cas(shape, seed=11 + sum(shape)))
    dmax, same = _agree(cas_quantize_blocked(v, 0.2).numpy(),
                        cas_quantize_reference(v, 0.2).numpy())
    assert dmax <= 1 and same >= MIN_IDENTICAL_VS_K3, (dmax, same)


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_mono_plain_is_the_woven_plain_version(shape):
    """K7 computes K3's arithmetic: its plain version equals K3's for every
    bh, and is within 1 LSB of the fp64 oracle."""
    v = _pre_cas(shape, seed=13 + sum(shape))
    want = cas_quantize_reference(torch.from_numpy(v), 0.2)
    for bh in (1, 32, 128):
        assert torch.equal(cas_quantize_mono(torch.from_numpy(v), 0.2, block_rows=bh), want)
    assert _agree(cas_quantize_mono_reference(torch.from_numpy(v), 0.2).numpy(),
                  _oracle_cas(v))[0] <= 1


# ---------------------------------------------------------------------------
# the woven-CAS A/B frame
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_ab_frame_matches_oracle_and_jax_frame(kernel):
    """The frame of the JAX A/B scripts at a small u=2 -p 2 plan: r2c_rows
    without a codec, the f32 weave_rows image, then K6 or K7 (plain
    versions on the CPU), against the fp64 oracle and the JAX frame through
    JAX cas_quantize_blocked / cas_quantize_mono (interpret)."""
    import jax
    import jax.numpy as jnp

    from vkresample_tpu.core.config import Engine as JEngine
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.fft import dense as jdense
    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.ops.cas_pallas import cas_quantize_blocked as jk6
    from vkresample_tpu.ops.cas_pallas import cas_quantize_mono as jk7
    from vkresample_tpu_torch import Engine, Precision, UpscalePlan
    from vkresample_tpu_torch.fft import dense
    from vkresample_tpu_torch.pipeline.upscale import make_device_banks

    h, w = 64, 128
    bh = 16 if kernel == "K6" else 32
    img = np.random.default_rng(17).integers(0, 256, (h, w, 3), np.uint8)

    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
    banks = make_device_banks(plan, Engine.MXU, "cpu", planes_out=False)
    v = dense.weave_rows(*dense.r2c_rows(torch.from_numpy(img).permute(2, 0, 1).contiguous(),
                                         banks), 2)
    cas = cas_quantize_blocked if kernel == "K6" else cas_quantize_mono
    got = cas(v, plan.sharpen, block_rows=bh).numpy()
    assert got.shape == (3, 2 * h, 2 * w)

    jplan = JPlan(h=h, w=w, upscale=2.0, precision=JPrecision.HALF, engine=JEngine.MXU)
    jbanks = mxu_pipeline.make_dense_banks(jplan)
    jU, jO = jdense.r2c_rows(jnp.moveaxis(jnp.asarray(img), -1, 0), jbanks,
                             jax.lax.Precision.HIGHEST)
    jcas = jk6 if kernel == "K6" else jk7
    jgot = np.asarray(jcas(jdense.weave_rows(jU, jO, 2), 0.2, block_rows=bh, interpret=True))

    want = np.moveaxis(toracle.upscale_oracle(img, plan), -1, 0)
    assert _agree(got, want)[0] <= 1
    assert _agree(got, jgot)[0] <= 1
    assert _agree(jgot, want)[0] <= 1


# ---------------------------------------------------------------------------
# wrapper rules
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_use_plain_versions():
    """On CPU tensors the wrappers return their plain versions' output
    (leading dims kept) and launch nothing."""
    v = torch.from_numpy(_pre_cas((2, 3, 10, 20), seed=19))
    before = (cas_quantize_blocked.launches, cas_quantize_mono.launches)
    got = cas_quantize_blocked(v, 0.2, block_rows=4)
    assert got.shape == v.shape
    assert torch.equal(got, cas_quantize_blocked_reference(v, *blocked_halo_rows(v, 4), 4, 0.2))
    assert torch.equal(cas_quantize_mono(v, 0.2, block_rows=4), cas_quantize_mono_reference(v, 0.2))
    assert (cas_quantize_blocked.launches, cas_quantize_mono.launches) == before


@pytest.mark.parametrize("shape,bh", [((1, 300, 70), 1), ((1, 300, 70), 193),
                                      ((2, 37, 201), 1000)])
def test_mono_takes_any_block_rows(shape, bh):
    """K7's segment height has no cap: bh 1, past the first design's 192
    rows and past H each give the plain version on a CPU tensor, and
    launch nothing."""
    v = torch.from_numpy(_pre_cas(shape, seed=41 + bh))
    before = cas_quantize_mono.launches
    assert torch.equal(cas_quantize_mono(v, 0.2, block_rows=bh), cas_quantize_mono_reference(v, 0.2))
    assert cas_quantize_mono.launches == before


@pytest.mark.parametrize("bh", [0, -1, 1.5])
def test_mono_block_rows_is_a_positive_integer(bh):
    with pytest.raises(ValueError, match="block_rows"):
        cas_quantize_mono(torch.zeros((1, 8, 16)), 0.2, block_rows=bh)


@pytest.mark.parametrize("W,v_ptr,out_ptr,form", [
    (4096, 0x7f0000000000, 0x7f0000100000, "bulk"), (4100, 16, 4, "bulk"),
    (4097, 16, 4, "per element"), (4096, 4, 0, "per element"), (4096, 16, 2, "per element"),
    (1, 0, 0, "per element"), (4, 32, 8, "bulk")])
def test_stream_form(W, v_ptr, out_ptr, form):
    """The copy form K7 and K10b take: bulk copies where a row is whole
    16-byte chunks and v and out are aligned, else per element."""
    assert stream_form(W, v_ptr, out_ptr) == form


@pytest.mark.parametrize("dtype", [torch.int16, torch.float64])
def test_wrappers_take_float32_only(dtype):
    v = torch.zeros((1, 8, 16), dtype=dtype)
    for fn in (cas_quantize_blocked, cas_quantize_mono, cas_quantize_mono_reference):
        with pytest.raises(TypeError, match="float32"):
            fn(v, 0.2)
    with pytest.raises(TypeError, match="float32"):
        cas_quantize_blocked_reference(v, *blocked_halo_rows(v, 4), 4, 0.2)


def test_wrappers_reject_bad_inputs():
    nc = torch.zeros((1, 16, 8)).transpose(1, 2)
    for fn in (cas_quantize_blocked, cas_quantize_mono):
        with pytest.raises(ValueError, match="contiguous"):
            fn(nc, 0.2)
        for bh in (0, -1, 2.5):
            with pytest.raises(ValueError, match="block_rows"):
                fn(torch.zeros((1, 8, 16)), 0.2, block_rows=bh)
    v = torch.zeros((1, 8, 16))
    top, bot = blocked_halo_rows(v, 4)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_quantize_blocked_reference(v, top[:, :1].contiguous(), bot, 4, 0.2)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_quantize_blocked_reference(v, top, bot, 3, 0.2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 201), (3, 256, 512), (1, 1, 1), (3, 2048, 4096),
                                   (2, 64, 4100), (2, 33, 4097), (3, 1, 4096), (2, 300, 1),
                                   (2, 129, 256), (24, 512, 1024)])
def test_cuda_blocked_and_mono_kernels_match_plain_versions(shape):
    """On the card: K6 equal to its plain version on every pixel and within
    1 LSB of K3, and K7 equal to its plain version and to K3 on every
    pixel, over several block heights (1, 7, 16, 32, 64, 128, 256, 1000
    and past H), at partial strips with W % 4 == 0 and != 0, H = 1, W = 1,
    H one row past a segment multiple and 24 planes; K7 also on a view of
    the image one float off a 16-byte boundary (its per-element copy
    form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    v = torch.rand(shape, generator=g, device="cuda") * 1.3 - 0.1
    buf = torch.empty(v.numel() + 1, device="cuda")
    buf[1:].copy_(v.reshape(-1))
    off = buf[1:].view(shape)
    k3 = cas_quantize(v, 0.2)
    for bh in (1, 7, 16, 32, 64, 128, 256, 1000, shape[1] + 5):
        k7_off = cas_quantize_mono(off, 0.2, block_rows=bh)
        assert cas_quantize_mono.staging == "per element"
        torch.cuda.synchronize()
        assert torch.equal(k7_off, k3), bh
        before = (cas_quantize_blocked.launches, cas_quantize_mono.launches)
        k6 = cas_quantize_blocked(v, 0.2, block_rows=bh)
        k7 = cas_quantize_mono(v, 0.2, block_rows=bh)
        assert cas_quantize_mono.staging == ("bulk" if shape[-1] % 4 == 0 else "per element")
        torch.cuda.synchronize()
        assert (cas_quantize_blocked.launches, cas_quantize_mono.launches) == (
            before[0] + 1, before[1] + 1)
        plain6 = cas_quantize_blocked_reference(v, *blocked_halo_rows(v, bh), bh, 0.2)
        assert torch.equal(k6, plain6), bh
        assert _agree(k6.cpu().numpy(), k3.cpu().numpy())[0] <= 1
        assert torch.equal(k7, cas_quantize_mono_reference(v, 0.2)), bh
        assert torch.equal(k7, k3), bh
