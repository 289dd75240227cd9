"""Port fused y-GEMM + CAS kernels (K8 ycas_parity_u2, K9 ycas_u2), their
y bank and their plain versions, against the JAX package's Pallas kernels
(interpret mode on the CPU), the rows route they would replace and the
fp64 oracle.

Tolerances: against the JAX kernels and against the rows route's unfused
output in -p 0 (y GEMM + K2), <= 1 LSB and >= 99.9 % of pixels identical
(the y contraction is summed in another order, and the CAS blend can flip
a truncation).  Against the rows route in -p 2, <= 1 LSB and >= 99.5 %
identical: that route stores O as Q2.14 before its CAS and the fused form
keeps O float32, a difference of up to 2^-15 in CAS units (0.008 LSB after
x255) that flips the truncation of ~0.3 % of pixels (0.28 % at 48x96,
256x384 and 540x720 on the CPU).  Against the fp64 oracle, <= 1 LSB (the
JAX package's bar).  The bank is bit-equal to the JAX one: both are the
same f64 numbers cast to float32."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch import Precision, UpscalePlan
from vkresample_tpu_torch.fft import dense
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.cas_cuda import cas_parity_planes_u2_reference
from vkresample_tpu_torch.ops.ycas_cuda import (
    ycas_bank_padded,
    ycas_odd_rows_reference,
    ycas_parity_u2,
    ycas_parity_u2_reference,
    ycas_u2,
    ycas_u2_reference,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle

MIN_IDENTICAL = 0.999
MIN_IDENTICAL_VS_Q214_ROUTE = 0.995  # the -p 2 rows route rounds O to Q2.14
JAX_GEOMETRIES = [(64, 256), (32, 192)]  # (h, w) of tests/test_ycas.py
# (h, W, r): geometries the JAX kernels reject (odd h, W % 128 != 0),
# single rows and columns, T2 absent and present
ODD_CASES = [(37, 200, 0), (37, 200, 2), (1, 200, 1), (1, 5, 0), (2, 1, 1), (70, 130, 1)]


def _agree(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return d.max(), (d == 0).mean()


def _woven(E, D):
    return torch.stack([E, D], dim=-2).reshape(E.shape[:-2] + (2 * E.shape[-2], E.shape[-1]))


def _jax_setup(monkeypatch, h, w, seed):
    """The JAX u=2 half-mode row-split banks with the ycas banks, the x
    pass (U, T2) of a seeded frame, and the oracle's planar output."""
    import jax
    import jax.numpy as jnp

    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.fft import dense as jdense

    monkeypatch.setenv("VKRESAMPLE_YCAS_BANKS", "1")  # the ycas banks are opt-in
    jb = jdense.r2c_rows_banks(JPlan(h=h, w=w, upscale=2.0, precision=JPrecision.HALF),
                               "float32")
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    U, T2 = jdense.r2c_x_only(jnp.moveaxis(jnp.asarray(img), -1, 0), jb,
                              jax.lax.Precision.HIGHEST)
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
    want = np.moveaxis(toracle.upscale_oracle(img, plan), -1, 0)
    return jb, np.array(U), np.array(T2), plan, want


def _oracle_fused(U, T2, YT):
    """fp64 oracle of the fused kernels: O = YT @ [load(U); T2] in f64, the
    woven (U, O), the oracle CAS."""
    Uf = np.asarray((cas.from_i16_storage(U) if U.dtype == torch.int16 else U).numpy(),
                    np.float64)
    Y = YT.numpy().astype(np.float64)
    h = Uf.shape[-2]
    O = Y[:, :h] @ Uf
    if T2 is not None:
        O = O + Y[:, h:] @ T2.numpy().astype(np.float64)
    v = np.stack([Uf, O], axis=-2).reshape(Uf.shape[:-2] + (2 * h, Uf.shape[-1]))
    return np.stack([toracle.quantize_u8(toracle.cas_sharpen(c, 0.2, False)) for c in v])


def _odd_inputs(h, W, r, dtype, seed, C=2):
    rng = np.random.default_rng(seed)
    U = torch.from_numpy(rng.random((C, h, W), np.float32) * 1.3 - 0.1)
    YT = torch.from_numpy((rng.standard_normal((h, h + r)) * 0.6 / np.sqrt(h + r))
                          .astype(np.float32))
    T2 = torch.from_numpy(rng.random((C, r, W), np.float32) * 0.1 - 0.05) if r else None
    return (cas.to_i16_storage(U) if dtype == "int16" else U), T2, YT


# ---------------------------------------------------------------------------
# the y bank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", JAX_GEOMETRIES + [(48, 96)])
def test_ycas_bank_matches_jax(monkeypatch, h, w):
    """dense.ycas_bank equals the first h + r columns of JAX ycasYT (the rest
    are zero pad), and banks_from_jax carries ycasYT over as that bank and
    drops ycasYT2."""
    from vkresample_tpu_torch.weights import banks_from_jax

    jb = _jax_setup(monkeypatch, h, w, seed=0)[0]
    yt = dense.ycas_bank(UpscalePlan(h=h, w=w, upscale=2.0))
    r = jb["Ymat_ns"].shape[0] - h
    assert yt.dtype == np.float32 and yt.shape == (h, h + r) and r == 1
    np.testing.assert_array_equal(yt, jb["ycasYT"][:, : h + r])
    assert not np.asarray(jb["ycasYT"][:, h + r:]).any()
    tb = banks_from_jax(jb, "cpu")
    np.testing.assert_array_equal(tb["ycasYT"].numpy(), yt)
    assert "ycasYT2" in jb and "ycasYT2" not in tb


@pytest.mark.parametrize("kw", [dict(upscale=3.0), dict(upscale=2.0, r2c=False),
                                dict(upscale=1.5), dict(upscale=1.0)])
def test_ycas_bank_rejects_other_geometries(kw):
    with pytest.raises(ValueError, match="u=2 row-split"):
        dense.ycas_bank(UpscalePlan(h=32, w=64, **kw))


# ---------------------------------------------------------------------------
# K8 / K9 against the JAX kernels and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("h,w", JAX_GEOMETRIES)
def test_k9_plain_matches_jax_kernel(monkeypatch, h, w, dtype):
    """K9's plain version against JAX ycas_u2 (interpret): f32 U with the
    f32 bank in "highest" mode, Q2.14 U with the bf16 hi|lo bank in
    "bf16x3" mode, as tests/test_ycas.py runs them."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import to_i16_storage as jst
    from vkresample_tpu.ops.ycas_pallas import ycas_u2 as jk9

    jb, U, T2, plan, want = _jax_setup(monkeypatch, h, w, seed=h + w)
    jU = jnp.asarray(U) if dtype == "float32" else jst(jnp.asarray(U))
    yt, mm = (jb["ycasYT"], "highest") if dtype == "float32" else (jb["ycasYT2"], "bf16x3")
    jout = np.asarray(jk9(jU, jnp.asarray(T2), jnp.asarray(yt), 0.2, Wb=128, bo=16, mm=mm,
                          interpret=True))
    got = ycas_u2(torch.from_numpy(np.array(jU)), torch.from_numpy(T2),
                  torch.from_numpy(dense.ycas_bank(plan)), 0.2)
    assert got.dtype == torch.uint8 and got.shape == (3, 2 * h, 2 * w)
    dmax, same = _agree(got.numpy(), jout)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)
    assert _agree(got.numpy(), want)[0] <= 1
    assert _agree(jout, want)[0] <= 1


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("h,w", JAX_GEOMETRIES)
def test_k8_plain_matches_jax_kernel(monkeypatch, h, w, dtype):
    """K8's plain version against JAX ycas_parity_u2 (interpret, bf16 hi|lo
    bank): both planes."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import to_i16_storage as jst
    from vkresample_tpu.ops.ycas_pallas import ycas_parity_u2 as jk8

    jb, U, T2, plan, want = _jax_setup(monkeypatch, h, w, seed=2 * h + w)
    jU = jnp.asarray(U) if dtype == "float32" else jst(jnp.asarray(U))
    jE, jD = jk8(jU, jnp.asarray(T2), jnp.asarray(jb["ycasYT2"]), 0.2, Wb=128, bo=16,
                 interpret=True)
    E, D = ycas_parity_u2(torch.from_numpy(np.array(jU)), torch.from_numpy(T2),
                          torch.from_numpy(dense.ycas_bank(plan)), 0.2)
    assert E.shape == D.shape == (3, h, 2 * w)
    dmax, same = _agree(np.stack([E.numpy(), D.numpy()]), np.stack([jE, jD]))
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)
    assert _agree(_woven(E, D).numpy(), want)[0] <= 1


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("h,W,r", ODD_CASES)
def test_fused_plain_matches_fp64_oracle_any_shape(h, W, r, dtype):
    """Any h, W >= 1, T2 absent or present: K8's planes are the even and odd
    rows of K9's woven image, within 1 LSB of the fp64 oracle."""
    U, T2, YT = _odd_inputs(h, W, r, dtype, seed=h * W + r)
    E, D = ycas_parity_u2_reference(U, T2, YT, 0.2)
    woven = ycas_u2_reference(U, T2, YT, 0.2)
    assert woven.shape == (2, 2 * h, W)
    np.testing.assert_array_equal(_woven(E, D).numpy(), woven.numpy())
    assert _agree(woven.numpy(), _oracle_fused(U, T2, YT))[0] <= 1


@pytest.mark.parametrize("prec", [Precision.SINGLE, Precision.HALF])
def test_fused_matches_rows_route(prec):
    """The fused form on the x pass (dense.r2c_x_only) against the rows
    route's unfused form (dense.r2c_rows: y GEMM, Q2.14 O in -p 2; then K2),
    and both against the oracle."""
    h, w = 48, 96
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=prec)
    banks = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in dense.r2c_rows_banks(plan).items()}
    img = np.random.default_rng(int(prec) + 5).integers(0, 256, (h, w, 3), np.uint8)
    x = torch.from_numpy(img).permute(2, 0, 1).contiguous()
    codec = (dict(store=cas.to_i16_storage, load=cas.from_i16_storage)
             if prec is Precision.HALF else {})
    rows = cas_parity_planes_u2_reference(*dense.r2c_rows(x, banks, **codec), 0.2)
    U, T2 = dense.r2c_x_only(x, banks)
    if prec is Precision.HALF:
        U = cas.to_i16_storage(U)
    fused = ycas_parity_u2(U, T2, torch.from_numpy(dense.ycas_bank(plan)), 0.2)
    dmax, same = _agree(torch.stack(fused).numpy(), torch.stack(rows).numpy())
    bar = MIN_IDENTICAL_VS_Q214_ROUTE if prec is Precision.HALF else MIN_IDENTICAL
    assert dmax <= 1 and same >= bar, (dmax, same)
    want = np.moveaxis(toracle.upscale_oracle(img, plan), -1, 0)
    assert _agree(_woven(*fused).numpy(), want)[0] <= 1


def test_odd_rows_reference_is_the_rows_route_y_gemm():
    """The plain versions' y GEMM with the ycas bank is the rows route's
    non-sample rows in f32 (the same bank, transposed)."""
    plan = UpscalePlan(h=32, w=64, upscale=2.0)
    banks = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in dense.r2c_rows_banks(plan).items()}
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 32, 64), np.uint8))
    U, T2 = dense.r2c_x_only(x, banks)
    Uf, O = ycas_odd_rows_reference(U, T2, torch.from_numpy(dense.ycas_bank(plan)))
    assert Uf is U
    assert (O - dense.r2c_rows(x, banks)[1]).abs().max() <= 2e-6


def test_fused_wrappers_on_cpu_use_plain_versions():
    """On CPU tensors the wrappers return their plain versions' output
    (leading dims kept) and launch nothing."""
    U, T2, YT = _odd_inputs(6, 20, 1, "float32", seed=4, C=3)
    U, T2 = U.reshape(1, 3, 6, 20), T2.reshape(1, 3, 1, 20)
    before = (ycas_parity_u2.launches, ycas_u2.launches)
    for a, b in zip(ycas_parity_u2(U, T2, YT, 0.2), ycas_parity_u2_reference(U, T2, YT, 0.2)):
        assert torch.equal(a, b) and a.shape == (1, 3, 6, 20)
    assert torch.equal(ycas_u2(U, T2, YT, 0.2), ycas_u2_reference(U, T2, YT, 0.2))
    assert (ycas_parity_u2.launches, ycas_u2.launches) == before


def test_fused_wrappers_reject_bad_inputs():
    U, T2, YT = _odd_inputs(8, 16, 1, "float32", seed=5)
    for fn in (ycas_parity_u2, ycas_u2):
        with pytest.raises(ValueError, match="T2 is None"):
            fn(U, None, YT, 0.2)
        with pytest.raises(ValueError, match="YT must be float32"):
            fn(U, T2, YT[:7], 0.2)
        with pytest.raises(ValueError, match="YT must be float32"):
            fn(U, T2, YT.double(), 0.2)
        with pytest.raises(ValueError, match="T2 must be float32"):
            fn(U, T2[:, :, :8].contiguous(), YT, 0.2)
        with pytest.raises(ValueError, match="T2 must be float32"):
            fn(U, torch.zeros((2, 1, 16)), YT[:, :8].contiguous(), 0.2)
        with pytest.raises(ValueError, match="contiguous"):
            fn(U, T2, YT.t().contiguous().t(), 0.2)
        with pytest.raises(TypeError, match="int16 or float32"):
            fn(U.double(), T2, YT, 0.2)


def tf32_rna(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds (csrc/ycas.cu's
    tf32_rna): to nearest, ties away from zero, the 13 low mantissa bits
    cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def test_tf32_rna_rounds_as_cvt_rna():
    """tf32_rna keeps 10 mantissa bits, rounding to nearest with ties away
    from zero (cvt.rna.tf32.f32), on both signs."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, 1 + 3 * ulp / 2, 1 + ulp / 4,
                      -(1 + ulp / 2), 0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1, 1 + 2 * ulp, 1, -(1 + ulp), 0.0, 3.0])
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(1000).astype(np.float32))
    assert not (tf32_rna(y).view(torch.int32) & 0x1FFF).any()
    assert ((tf32_rna(y) - y).abs() <= y.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("h,r", [(8, 1), (37, 0), (37, 2), (1, 5)])
def test_ycas_bank_padded_layout(h, r):
    """The kernels' bank: YT's U columns at 0 and its T2 columns at h rounded
    up to 4, rows of a multiple of 4, zero elsewhere; the wrappers make it
    once per bank tensor and again after an in-place change."""
    from vkresample_tpu_torch.ops.ycas_cuda import _bank_padded

    YT = torch.from_numpy(np.random.default_rng(h + r).standard_normal((h, h + r))
                          .astype(np.float32))
    b = ycas_bank_padded(YT)
    hp, rp = -(-h // 4) * 4, -(-r // 4) * 4
    assert b.shape == (h, hp + rp) and b.dtype == torch.float32
    assert torch.equal(torch.cat([b[:, :h], b[:, hp:hp + r]], dim=-1), YT)
    assert not b[:, h:hp].any() and not b[:, hp + r:].any()
    kept = _bank_padded(YT)
    assert torch.equal(kept, b) and _bank_padded(YT) is kept
    YT.mul_(2)
    assert torch.equal(_bank_padded(YT), 2 * b)


def _odd_rows_3xtf32(U, T2, YT, chunk=32):
    """The y GEMM in the kernels' numerical form: U dequantized, the bank as
    the kernels read it (ycas_bank_padded), every value split into TF32 hi
    + lo, the U rows then the T2 rows in 32-deep chunks, each chunk lo.hi +
    hi.lo + hi.hi in float32 into a fresh sum that is added to O."""
    h = U.shape[-2]
    Uf = cas.from_i16_storage(U) if U.dtype == torch.int16 else U
    bank = ycas_bank_padded(YT)
    O = torch.zeros(U.shape, dtype=torch.float32)
    for B, kbase in ((Uf, 0), (T2, -(-h // 4) * 4)):
        if B is None:
            continue
        for k0 in range(0, B.shape[-2], chunk):
            k1 = min(k0 + chunk, B.shape[-2])
            ah = tf32_rna(bank[:, kbase + k0:kbase + k1])
            al = tf32_rna(bank[:, kbase + k0:kbase + k1] - ah)
            bh = tf32_rna(B[..., k0:k1, :])
            bl = tf32_rna(B[..., k0:k1, :] - bh)
            O = O + ((al @ bh + ah @ bl) + ah @ bh)
    return Uf, O


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("h,w", [(136, 180), (270, 360)])
def test_3xtf32_form_meets_the_bar(h, w, dtype):
    """The kernels' 3xTF32 y GEMM, emulated in torch on a real bank and a
    seeded frame's x pass, gives the plain version's CAS output within 1
    LSB on >= 99.9 % of pixels; its O is within 2^-19 of the float64 GEMM
    and no further from it than the float32 GEMM's.  TF32 alone (hi.hi) is
    over 2^-14 away."""
    plan = UpscalePlan(h=h, w=w, upscale=2.0)
    banks = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in dense.r2c_rows_banks(plan).items()}
    img = np.random.default_rng(h + w).integers(0, 256, (3, h, w), np.uint8)
    U, T2 = dense.r2c_x_only(torch.from_numpy(img), banks)
    if dtype == "int16":
        U = cas.to_i16_storage(U)
    YT = torch.from_numpy(dense.ycas_bank(plan))
    Uf, O = _odd_rows_3xtf32(U, T2, YT)
    want_O = ycas_odd_rows_reference(U, T2, YT)[1]
    Y64 = YT.double()
    O64 = Y64[:, :h] @ Uf.double() + Y64[:, h:] @ T2.double()
    err = (O.double() - O64).abs().max()
    assert err <= 2.0 ** -19 and err <= (want_O.double() - O64).abs().max()
    got = cas_parity_planes_u2_reference(Uf, O, 0.2)
    dmax, same = _agree(torch.stack(got).numpy(),
                        torch.stack(ycas_parity_u2_reference(U, T2, YT, 0.2)).numpy())
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)
    tf32_only = torch.matmul(tf32_rna(YT[:, :h]), tf32_rna(Uf)) + torch.matmul(
        tf32_rna(YT[:, h:]), tf32_rna(T2))
    assert (tf32_only.double() - O64).abs().max() > 2.0 ** -14


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _misaligned(p):
    """p as a contiguous view one element (2 or 4 bytes) past the start of
    its buffer, as chip_smoke.py phase 3 makes it."""
    buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=p.device)
    buf[1:].copy_(p.reshape(-1))
    return buf[1:].view(p.shape)


def _cuda_case(h, W, r, dtype, seed, misaligned=False):
    """Seeded inputs on the card: the frame's own y bank where (h, W/2, u=2)
    is a row-split plan with r = 1, else a random bank; U 2 or 4 bytes past
    a 16-byte boundary if misaligned."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    U = torch.rand((3, h, W), generator=g, device="cuda") * 1.3 - 0.1
    if h % 2 == 0 and W % 2 == 0 and r == 1:
        YT = torch.from_numpy(dense.ycas_bank(UpscalePlan(h=h, w=W // 2, upscale=2.0)))
    else:
        YT = torch.randn((h, h + r), generator=g, device="cuda") * (0.6 / (h + r) ** 0.5)
    T2 = torch.rand((3, r, W), generator=g, device="cuda") * 0.1 - 0.05 if r else None
    U = cas.to_i16_storage(U) if dtype == torch.int16 else U
    return _misaligned(U) if misaligned else U, T2, YT.to("cuda").contiguous()


# (h, W, r, misaligned U): the route shapes; the 128 x 128 tile's band edges
# (h = 127, 128, 129, 255) and strip edges (W = 126, 127, 128, 129, 257; W %
# 8 != 0 stages int16 per element); K = h + r off multiples of 8 and 32 and
# on them (16-byte YT rows), r = 0, 1, 2; U 2 or 4 bytes past a 16-byte
# boundary; single rows and columns
CUDA_CASES = [
    (1080, 2880, 1, False), (1024, 4096, 1, False), (37, 200, 0, False), (37, 200, 2, False),
    (1, 200, 1, False), (1, 1, 0, False),
    (127, 200, 0, False), (128, 256, 1, False), (129, 130, 2, False), (255, 129, 1, False),
    (124, 256, 4, False), (126, 384, 2, False), (40, 126, 1, False), (40, 127, 0, False),
    (40, 128, 2, False), (40, 129, 1, False), (40, 257, 1, False),
    (130, 264, 1, True), (1080, 2880, 1, True), (37, 200, 2, True),
    (1, 1, 2, False), (1, 300, 0, False), (300, 1, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("h,W,r,mis", CUDA_CASES)
def test_cuda_fused_kernels_match_plain_versions(h, W, r, mis, dtype):
    """On the card: K8 and K9 against their plain versions (<= 1 LSB,
    >= 99.9 % identical), K9 the woven K8, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    U, T2, YT = _cuda_case(h, W, r, dtype, seed=h + W + r, misaligned=mis)
    assert mis == (U.data_ptr() % 16 != 0)
    before = (ycas_parity_u2.launches, ycas_u2.launches)
    E, D = ycas_parity_u2(U, T2, YT, 0.2)
    woven = ycas_u2(U, T2, YT, 0.2)
    torch.cuda.synchronize()
    assert (ycas_parity_u2.launches, ycas_u2.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(_woven(E, D), woven)
    want = ycas_parity_u2_reference(U, T2, YT, 0.2)
    dmax, same = _agree(torch.stack((E, D)).cpu().numpy(), torch.stack(want).cpu().numpy())
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)
