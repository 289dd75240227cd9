"""Port quad-parity CAS (kernel wrapper + plain version) against the JAX
package's Pallas kernel K1 (interpret mode on the CPU) and the fp64 oracle.

The plain version and K1 evaluate the same _cas_blend (rsqrt form, 1e-30
floor) in float32 but with different operation fusion, so truncation to
uint8 can flip on values within an ulp of an integer: <= 1 LSB, >= 99.9 %
of pixels identical.  On the card the kernel (the grid kernel's U = 2
instance, csrc/cas_grid.cu) equals its plain version on every pixel: both
evaluate cas_common.cuh's operations in the same order."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.cas_cuda import (
    cas_parity4_planes_u2,
    cas_parity4_planes_u2_reference,
    cas_parity_grid_planes_reference,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle

MIN_IDENTICAL = 0.999


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, np.float32) * 1.3 - 0.1 for _ in range(4)]


def _weave(ps):
    ps = [np.asarray(p) for p in ps]
    C, h, w = ps[0].shape
    out = np.empty((C, 2 * h, 2 * w), ps[0].dtype)
    out[:, 0::2, 0::2], out[:, 0::2, 1::2] = ps[0], ps[1]
    out[:, 1::2, 0::2], out[:, 1::2, 1::2] = ps[2], ps[3]
    return out


def _agree(got, want):
    d = np.abs(_weave(got).astype(np.int32) - _weave(want).astype(np.int32))
    return d.max(), (d == 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 32, 256)])
def test_plain_matches_jax_quad_kernel(shape, dtype):
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import to_i16_storage as jst
    from vkresample_tpu.ops.cas_pallas import cas_parity4_planes_u2 as jk1

    P = _planes(shape, seed=shape[1] + shape[2])
    jP = [jnp.asarray(p) for p in P]
    tP = [torch.from_numpy(p) for p in P]
    if dtype == "int16":
        jP = [jst(p) for p in jP]
        tP = [cas.to_i16_storage(p) for p in tP]
        np.testing.assert_array_equal(tP[0].numpy(), np.asarray(jP[0]))
    want = jk1(*jP, 0.2, block_rows=16, interpret=True)
    got = cas_parity4_planes_u2_reference(*tP, 0.2)
    assert all(g.dtype == torch.uint8 and g.shape == shape for g in got)
    dmax, same = _agree([g.numpy() for g in got], want)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("shape", [(2, 32, 128), (2, 37, 200), (1, 17, 3), (2, 9, 1), (1, 1, 1)])
def test_grid_plain_at_u2_is_the_quad_plain_and_matches_jax_quad_kernel(shape, dtype):
    """K4's plain version at u = 2 (the yardstick of the grid kernel's U = 2
    instance, which runs K1 on the card) equals K1's plain version on every
    pixel, and is within K1's bar of JAX cas_parity4_planes_u2 (interpret),
    at a 128-aligned width and odd ones: h and Wh off any tile, W % 4 != 0,
    one plane column, one pixel."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import to_i16_storage as jst
    from vkresample_tpu.ops.cas_pallas import cas_parity4_planes_u2 as jk1

    P = _planes(shape, seed=3 + sum(shape))
    jP = [jnp.asarray(p) for p in P]
    tP = [torch.from_numpy(p) for p in P]
    if dtype == "int16":
        jP = [jst(p) for p in jP]
        tP = [cas.to_i16_storage(p) for p in tP]
    got = cas_parity_grid_planes_reference(tP, 2, 0.2)
    assert all(g.dtype == torch.uint8 and g.shape == shape for g in got)
    for g, q in zip(got, cas_parity4_planes_u2_reference(*tP, 0.2)):
        assert torch.equal(g, q)
    dmax, same = _agree([g.numpy() for g in got], jk1(*jP, 0.2, interpret=True))
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("shape", [(2, 37, 200), (1, 1, 1), (1, 3, 2), (3, 16, 64)])
def test_plain_matches_fp64_oracle_any_shape(shape):
    """Any h, Wh >= 1 (the clamp-to-edge stencil on the woven image): the
    f32 plain version is within 1 LSB of the oracle's f64 CAS."""
    P = _planes(shape, seed=sum(shape))
    got = cas_parity4_planes_u2_reference(*[torch.from_numpy(p) for p in P], 0.2)
    v = _weave(P).astype(np.float64)
    want = np.stack([toracle.quantize_u8(toracle.cas_sharpen(v[c], 0.2, False))
                     for c in range(shape[0])])
    d = np.abs(_weave([g.numpy() for g in got]).astype(np.int32) - want)
    assert d.max() <= 1


def test_plain_matches_woven_torch_cas():
    """Same as the port's woven cas_sharpen (sqrt/divide form) + quantize,
    within 1 LSB (the rsqrt blend shifts boundary pixels by one)."""
    P = [torch.from_numpy(p) for p in _planes((3, 32, 128), seed=5)]
    got = cas_parity4_planes_u2_reference(*P, 0.2)
    woven = cas.quantize_u8(cas.cas_sharpen(torch.from_numpy(_weave(P)), 0.2))
    dmax, same = _agree([g.numpy() for g in got], _split(woven.numpy()))
    assert dmax <= 1 and same >= MIN_IDENTICAL


def _split(v):
    return [v[:, ry::2, rx::2] for ry, rx in ((0, 0), (0, 1), (1, 0), (1, 1))]


def test_sharpen_zero_and_flat_input():
    """s=0 leaves the clipped signal; a flat plane (num == 0 everywhere)
    gives finite output thanks to the 1e-30 floor."""
    P = [torch.full((1, 8, 16), 0.5) for _ in range(4)]
    for s in (0.0, 0.2):
        outs = cas_parity4_planes_u2_reference(*P, s)
        assert all(int(o.min()) == int(o.max()) == 127 for o in outs)
    Z = [torch.zeros((1, 8, 16)) for _ in range(4)]
    assert all(int(o.max()) == 0 for o in cas_parity4_planes_u2_reference(*Z, 0.2))


def test_wrapper_on_cpu_uses_plain_version_and_keeps_leading_dims():
    P = [torch.from_numpy(p) for p in _planes((2, 3, 16, 32), seed=8)]
    before = cas_parity4_planes_u2.launches
    got = cas_parity4_planes_u2(*P, 0.2)
    want = cas_parity4_planes_u2_reference(*P, 0.2)
    assert cas_parity4_planes_u2.launches == before  # no kernel launch on CPU
    assert all(g.shape == (2, 3, 16, 32) for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_mismatched_planes():
    P = [torch.zeros((1, 8, 16)) for _ in range(4)]
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_parity4_planes_u2(P[0], P[1], P[2], P[3].to(torch.int16), 0.2)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_parity4_planes_u2(P[0], P[1], P[2], torch.zeros((1, 8, 8)), 0.2)
    with pytest.raises(TypeError, match="int16 or float32"):
        cas_parity4_planes_u2(*[p.double() for p in P], 0.2)
    t = torch.zeros((1, 16, 8)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cas_parity4_planes_u2(t, t, t, t, 0.2)


def _cuda_planes(shape, dtype, seed, offset=0):
    """Four seeded planes on the card; with `offset` each is a contiguous
    view that starts `offset` elements into its buffer (2 or 4 bytes for
    offset 1), so the kernel takes its per-element staging copies."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    P = []
    for _ in range(4):
        buf = torch.rand(n + offset, generator=g, device="cuda") * 1.3 - 0.1
        if dtype == torch.int16:
            buf = cas.to_i16_storage(buf)
        P.append(buf[offset:].view(shape))
    return P


def _cuda_exact(P):
    before = cas_parity4_planes_u2.launches
    got = cas_parity4_planes_u2(*P, 0.2)
    torch.cuda.synchronize()
    assert cas_parity4_planes_u2.launches == before + 1
    want = cas_parity4_planes_u2_reference(*P, 0.2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape", [(3, 1024, 2048), (2, 37, 200), (1, 1, 1)])
def test_cuda_kernel_matches_plain_version(shape, dtype):
    """On the card: the hand-written kernel identical to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_exact(_cuda_planes(shape, dtype, seed=1))


# h and Wh off the kernel's 16-row band and 64-column strip; Wh % 4 != 0
# (byte stores) and Wh % 8 != 0 (per-element staging of int16, where Wh * 2
# % 16 != 0); one plane row or column; then planes one element (2 or 4
# bytes) past a 16-byte boundary at widths the 16-byte copies would take
EDGE_CASES = (
    [((2, 37, 201), 0), ((2, 19, 136), 0), ((2, 21, 202), 0), ((2, 13, 132), 0),
     ((2, 65, 70), 0), ((1, 1, 70), 0), ((2, 40, 1), 0), ((1, 17, 3), 0), ((1, 1, 129), 0)]
    + [((2, 21, 136), 1), ((2, 37, 200), 1), ((3, 1024, 2048), 1)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape,offset", EDGE_CASES)
def test_cuda_kernel_edge_shapes_and_misaligned_planes(shape, offset, dtype):
    """On the card: K1 identical on every pixel to its plain version off its
    band and strip edges, at odd widths, single rows and columns, and on
    misaligned planes (the per-element staging form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_exact(_cuda_planes(shape, dtype, seed=5 + sum(shape), offset=offset))
