"""Port rows-parity CAS (K2) and woven CAS (K3), wrappers and plain
versions, against the JAX package's Pallas kernels (interpret mode on the
CPU) and the fp64 oracle CAS.

Tolerances: against the JAX kernels, <= 1 LSB and >= 99.9 % of pixels
identical (both evaluate the same rsqrt blend in float32 with different
operation fusion, so truncation to uint8 can flip on values within an ulp
of an integer; the K1 bar of test_torch_cas.py).  Against the fp64 oracle
(sqrt/divide form in f64), <= 1 LSB.  K2's plain version equals K5's at u
= 2, split into even and odd rows, on every pixel.  On the card K3 and K2
(csrc/cas_rows.cu's kernel at u = 1 and u = 2) equal their plain versions
on every pixel."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.cas_cuda import (
    cas_parity_planes_u2,
    cas_parity_planes_u2_reference,
    cas_quantize,
    cas_quantize_reference,
    cas_quantize_rows_u_reference,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle

MIN_IDENTICAL = 0.999
SHAPES = [(3, 64, 128), (2, 32, 256)]
ODD_SHAPES = [(2, 37, 200), (1, 1, 1), (1, 3, 2), (1, 9, 1440), (2, 5, 202)]


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


def _both(arrays, dtype):
    """The same inputs as JAX arrays and torch tensors, Q2.14-stored for
    int16 (the two codecs agree bit for bit, test_torch_dense.py)."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import to_i16_storage as jst

    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    if dtype == "int16":
        j = [jst(a) for a in j]
        t = [cas.to_i16_storage(a) for a in t]
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_woven_plain_matches_jax_kernel(shape, dtype):
    """K3's plain version against JAX cas_quantize_pallas (interpret)."""
    from vkresample_tpu.ops.cas_pallas import cas_quantize_pallas

    (jv,), (tv,) = _both([_pre_cas(shape, seed=sum(shape))], dtype)
    want = cas_quantize_pallas(jv, 0.2, block_rows=16, interpret=True)
    got = cas_quantize_reference(tv, 0.2)
    assert got.dtype == torch.uint8 and got.shape == shape
    dmax, same = _agree(got.numpy(), want)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_parity_plain_matches_jax_kernel(shape, dtype):
    """K2's plain version against JAX cas_parity_planes_u2 (interpret)."""
    from vkresample_tpu.ops.cas_pallas import cas_parity_planes_u2 as jk2

    arrays = [_pre_cas(shape, seed=s + sum(shape)) for s in (1, 2)]
    jUO, tUO = _both(arrays, dtype)
    want = jk2(*jUO, 0.2, block_rows=16, interpret=True)
    got = cas_parity_planes_u2_reference(*tUO, 0.2)
    assert all(g.dtype == torch.uint8 and g.shape == shape for g in got)
    dmax, same = _agree(np.stack([g.numpy() for g in got]), np.stack(want))
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("shape", [(2, 32, 128), (2, 37, 200), (1, 17, 3), (2, 9, 1), (1, 1, 1),
                                   (2, 1, 131)])
def test_rows_plain_at_u2_is_the_parity_plain_and_matches_jax_parity_kernel(shape, dtype):
    """K5's plain version at u = 2, split into its even and odd rows (the
    yardstick of csrc/cas_rows.cu's kernel at u = 2, which runs K2 on the
    card) equals K2's plain version on every pixel, and is within K2's bar
    of JAX cas_parity_planes_u2 (interpret), at a 128-aligned width and odd
    ones: h and W off any tile, W % 4 != 0, one column, one row, one
    pixel."""
    from vkresample_tpu.ops.cas_pallas import cas_parity_planes_u2 as jk2

    arrays = [_pre_cas(shape, seed=s + 5 * sum(shape)) for s in (1, 2)]
    jUO, (U, O) = _both(arrays, dtype)
    woven = cas_quantize_rows_u_reference(U, O, 2, 0.2)
    got = (woven[..., 0::2, :], woven[..., 1::2, :])
    assert all(g.dtype == torch.uint8 and g.shape == shape for g in got)
    for g, q in zip(got, cas_parity_planes_u2_reference(U, O, 0.2)):
        assert torch.equal(g, q)
    dmax, same = _agree(np.stack([g.numpy() for g in got]),
                        np.stack(jk2(*jUO, 0.2, interpret=True)))
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_woven_plain_matches_fp64_oracle_any_shape(shape):
    """Any H, W >= 1, non-128-aligned widths included."""
    v = _pre_cas(shape, seed=7 + sum(shape))
    got = cas_quantize_reference(torch.from_numpy(v), 0.2)
    assert np.abs(got.numpy().astype(np.int32) - _oracle_cas(v)).max() <= 1


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_parity_plain_matches_fp64_oracle_any_shape(shape):
    """Any h, W >= 1: the planes are the even and odd rows of the oracle's
    CAS of the row-woven image (even row 0 and odd row 2h-1 clamp to
    themselves)."""
    U, O = (_pre_cas(shape, seed=s + sum(shape)) for s in (3, 4))
    E, D = cas_parity_planes_u2_reference(torch.from_numpy(U), torch.from_numpy(O), 0.2)
    C, h, W = shape
    want = _oracle_cas(np.stack([U, O], axis=2).reshape(C, 2 * h, W))
    assert np.abs(E.numpy().astype(np.int32) - want[:, 0::2]).max() <= 1
    assert np.abs(D.numpy().astype(np.int32) - want[:, 1::2]).max() <= 1


def test_quad_plain_is_the_woven_plain_version_split():
    """K1's plain version weaves its planes and calls K3's: bit-equal to
    the woven plain version of the host-woven image."""
    from vkresample_tpu_torch.ops.cas_cuda import cas_parity4_planes_u2_reference

    P = [_pre_cas((2, 9, 14), seed=s) for s in range(4)]
    v = np.empty((2, 18, 28), np.float32)
    v[:, 0::2, 0::2], v[:, 0::2, 1::2], v[:, 1::2, 0::2], v[:, 1::2, 1::2] = P
    want = cas_quantize_reference(torch.from_numpy(v), 0.2).numpy()
    got = cas_parity4_planes_u2_reference(*[torch.from_numpy(p) for p in P], 0.2)
    for g, (ry, rx) in zip(got, ((0, 0), (0, 1), (1, 0), (1, 1))):
        np.testing.assert_array_equal(g.numpy(), want[:, ry::2, rx::2])


def test_wrappers_on_cpu_use_plain_versions():
    """On CPU tensors the wrappers return their plain versions' output
    (leading dims kept) and launch nothing."""
    v = torch.from_numpy(_pre_cas((2, 3, 10, 20), seed=11))
    U, O = v[0].contiguous(), v[1].contiguous()
    before = (cas_quantize.launches, cas_parity_planes_u2.launches)
    assert torch.equal(cas_quantize(v, 0.2), cas_quantize_reference(v, 0.2))
    for a, b in zip(cas_parity_planes_u2(U, O, 0.2), cas_parity_planes_u2_reference(U, O, 0.2)):
        assert torch.equal(a, b) and a.shape == (3, 10, 20)
    assert (cas_quantize.launches, cas_parity_planes_u2.launches) == before


def test_wrappers_reject_bad_inputs():
    z = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_parity_planes_u2(z, z.to(torch.int16), 0.2)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_parity_planes_u2(z, torch.zeros((1, 8, 8)), 0.2)
    with pytest.raises(TypeError, match="int16 or float32"):
        cas_quantize(z.double(), 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        cas_quantize(torch.zeros((1, 16, 8)).transpose(1, 2), 0.2)
    with pytest.raises(ValueError, match="rows, cols"):
        cas_quantize(torch.zeros(8), 0.2)


def _cuda_woven(shape, dtype, seed, offset=0):
    """A seeded image on the card; with `offset` a contiguous view that
    starts `offset` elements into its buffer (2 or 4 bytes for offset 1),
    so the kernel takes its per-element staging copies."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.rand(int(np.prod(shape)) + offset, generator=g, device="cuda") * 1.3 - 0.1
    if dtype == torch.int16:
        buf = cas.to_i16_storage(buf)
    return buf[offset:].view(shape)


def _cuda_woven_exact(v):
    before = cas_quantize.launches
    got = cas_quantize(v, 0.2)
    torch.cuda.synchronize()
    assert cas_quantize.launches == before + 1
    assert torch.equal(got, cas_quantize_reference(v, 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape", [(3, 2160, 3840), (2, 37, 201), (1, 1, 1)])
def test_cuda_woven_kernel_matches_plain_version(shape, dtype):
    """On the card: K3 identical to its plain version on every pixel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_woven_exact(_cuda_woven(shape, dtype, seed=2))


# K5's edge set at u = 1 (K3 is K5's kernel there): H and W off the 64-row
# band and the 128-column strip; W % 4 != 0 (byte stores) and W % 8 != 0
# (per-element staging of int16, where W * 2 % 16 != 0); H = 1; W = 1; then
# an image one element (2 or 4 bytes) past a 16-byte boundary at widths the
# 16-byte copies would take, the route shape among them
WOVEN_EDGE_CASES = (
    [((2, 37, 200), 0), ((2, 65, 131), 0), ((2, 21, 202), 0), ((2, 13, 132), 0),
     ((2, 64, 136), 0), ((2, 130, 129), 0), ((1, 1, 70), 0), ((1, 1, 129), 0),
     ((2, 40, 1), 0), ((3, 1080, 1920), 0), ((3, 1800, 3200), 0)]
    + [((2, 37, 200), 1), ((2, 21, 136), 1), ((3, 2160, 3840), 1)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape,offset", WOVEN_EDGE_CASES)
def test_cuda_woven_kernel_edge_shapes_and_misaligned_image(shape, offset, dtype):
    """On the card: K3 identical on every pixel to its plain version off its
    band and strip edges, at odd widths, single rows and columns, the chain
    routes' shapes, and on a misaligned image (the per-element staging
    form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_woven_exact(_cuda_woven(shape, dtype, seed=3 + sum(shape), offset=offset))


def _cuda_parity_exact(U, O):
    before = cas_parity_planes_u2.launches
    got = cas_parity_planes_u2(U, O, 0.2)
    torch.cuda.synchronize()
    assert cas_parity_planes_u2.launches == before + 1
    for g, q in zip(got, cas_parity_planes_u2_reference(U, O, 0.2)):
        assert torch.equal(g, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape", [(3, 1080, 2880), (2, 37, 200), (1, 1, 1)])
def test_cuda_parity_kernel_matches_plain_version(shape, dtype):
    """On the card: K2 (csrc/cas_rows.cu's kernel at u = 2) identical to its
    plain version on every pixel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_parity_exact(*(_cuda_woven(shape, dtype, seed=3 + s) for s in (0, 1)))


# K5's edge set at u = 2: h and 2h off the 64-row band (2h = 64 exactly,
# 74, 130, 42, 26); W off the 128-column strip; W % 4 != 0 (byte stores)
# and W % 8 != 0 (per-element staging of int16, where W * 2 % 16 != 0); h =
# 1; W = 1; the woven flagship's U and O; then U, O or both one element (2
# or 4 bytes) past a 16-byte boundary at widths the 16-byte copies would
# take, which takes the per-element staging form
PARITY_EDGE_CASES = (
    [((2, 37, 200), ""), ((2, 32, 136), ""), ((2, 65, 131), ""), ((2, 21, 202), ""),
     ((2, 13, 132), ""), ((1, 1, 70), ""), ((1, 1, 129), ""), ((2, 40, 1), ""),
     ((1, 1, 1), ""), ((3, 1024, 4096), "")]
    + [((2, 37, 200), "U"), ((2, 21, 136), "O"), ((2, 19, 264), "UO"),
       ((3, 1080, 2880), "UO")]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape,misaligned", PARITY_EDGE_CASES)
def test_cuda_parity_kernel_edge_shapes_and_misaligned_planes(shape, misaligned, dtype):
    """On the card: K2 identical on every pixel to its plain version off its
    band and strip edges, at odd widths, single rows and columns, the woven
    flagship's shape, and on misaligned U and O (the per-element staging
    form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    U, O = (_cuda_woven(shape, dtype, seed=5 + s + sum(shape), offset=int(p in misaligned))
            for s, p in enumerate("UO"))
    _cuda_parity_exact(U, O)
