"""Port grid-parity CAS (K4), wrapper and plain version, against the JAX
package's Pallas kernel (interpret mode on the CPU), the fp64 oracle CAS
and the port's woven CAS.

Tolerances: against the JAX kernel, <= 1 LSB and >= 99.9 % of pixels
identical (both evaluate the rsqrt blend in float32 with different
operation fusion, so truncation to uint8 can flip on values within an ulp
of an integer; measured: every case identical on >= 99.99 % of pixels).
Against the fp64 oracle (sqrt/divide form in f64), <= 1 LSB.  On the card
the kernel equals its plain version on every pixel: both evaluate
cas_common.cuh's operations in the same order."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.cas_cuda import (
    cas_parity_grid_planes,
    cas_parity_grid_planes_reference,
    cas_quantize_reference,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle

MIN_IDENTICAL = 0.999


def _planes(u, shape, seed):
    """u*u pre-CAS planes over [-0.1, 1.2): both clip branches and the
    negative side of |v| are exercised."""
    rng = np.random.default_rng(seed)
    return [rng.random(shape, np.float32) * 1.3 - 0.1 for _ in range(u * u)]


def _weave(planes, u):
    C, h, W = planes[0].shape
    v = np.empty((C, u * h, u * W), planes[0].dtype)
    for i, p in enumerate(planes):
        v[:, i // u::u, i % u::u] = p
    return v


def _agree(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return d.max(), (d == 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("shape", [(2, 32, 128), (2, 20, 200), (1, 1, 37), (2, 9, 1)])
@pytest.mark.parametrize("u", [3, 4, 2, 5, 8])
def test_grid_plain_matches_jax_kernel(u, shape, dtype):
    """K4's plain version against JAX cas_parity_grid_planes (interpret),
    at a 128-aligned width, a non-aligned one (the JAX kernel's
    replicate-pad reroute), one plane row (h = 1) and one plane column (W =
    1), at every u the card's kernel serves from 2 to its limit: the plain
    version is the yardstick the kernel is held to on the card."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import to_i16_storage as jst
    from vkresample_tpu.ops.cas_pallas import cas_parity_grid_planes as jk4

    arrays = _planes(u, shape, seed=u + sum(shape))
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    if dtype == "int16":
        j = [jst(a) for a in j]
        t = [cas.to_i16_storage(a) for a in t]
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    want = jk4(j, u, 0.2, interpret=True)
    got = cas_parity_grid_planes_reference(t, u, 0.2)
    assert len(got) == u * u
    assert all(g.dtype == torch.uint8 and g.shape == shape for g in got)
    dmax, same = _agree(np.stack([g.numpy() for g in got]), np.stack([np.asarray(w) for w in want]))
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("u,shape", [(3, (2, 7, 11)), (4, (1, 5, 9)), (5, (1, 1, 1)),
                                     (7, (2, 3, 4)), (2, (1, 6, 5))])
def test_grid_plain_is_the_woven_cas_split(u, shape):
    """The plain version weaves its planes and calls the woven plain
    version: bit-equal to the woven CAS of the host-woven image, and within
    1 LSB of the fp64 oracle CAS of it (every h, W >= 1: the image border
    is the woven image's clamp)."""
    P = _planes(u, shape, seed=7 * u + sum(shape))
    v = _weave(P, u)
    woven = cas_quantize_reference(torch.from_numpy(v), 0.2).numpy()
    oracle = np.stack([toracle.quantize_u8(toracle.cas_sharpen(c, 0.2, False))
                       for c in v.astype(np.float64)])
    got = cas_parity_grid_planes_reference([torch.from_numpy(p) for p in P], u, 0.2)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), woven[:, i // u::u, i % u::u])
        assert np.abs(g.numpy().astype(np.int32) - oracle[:, i // u::u, i % u::u]).max() <= 1


def test_grid_wrapper_on_cpu_uses_plain_version():
    """On CPU tensors the wrapper returns its plain version's output
    (leading dims kept) and launches nothing; it checks the plane count."""
    P = [torch.from_numpy(p) for p in _planes(3, (2, 3, 6, 10), seed=5)]
    before = cas_parity_grid_planes.launches
    for a, b in zip(cas_parity_grid_planes(P, 3, 0.2), cas_parity_grid_planes_reference(P, 3, 0.2)):
        assert torch.equal(a, b) and a.shape == (2, 3, 6, 10)
    assert cas_parity_grid_planes.launches == before
    with pytest.raises(ValueError, match="expected 16 planes"):
        cas_parity_grid_planes(P, 4, 0.2)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_parity_grid_planes(P[:8] + [P[8].to(torch.int16)], 3, 0.2)


def _cuda_planes(u, shape, dtype, offset=0):
    """u*u seeded planes on the card; with `offset` each is a contiguous
    view that starts `offset` elements into its buffer (2 or 4 bytes for
    offset 1), so the kernel takes its per-element staging copies."""
    g = torch.Generator(device="cuda").manual_seed(4 + u)
    n = int(np.prod(shape))
    P = []
    for _ in range(u * u):
        buf = torch.rand(n + offset, generator=g, device="cuda") * 1.3 - 0.1
        if dtype == torch.int16:
            buf = cas.to_i16_storage(buf)
        P.append(buf[offset:].view(shape))
    return P


def _cuda_exact(P, u):
    before = cas_parity_grid_planes.launches
    got = cas_parity_grid_planes(P, u, 0.2)
    torch.cuda.synchronize()
    assert cas_parity_grid_planes.launches == before + 1
    want = cas_parity_grid_planes_reference(P, u, 0.2)
    dmax, same = _agree(torch.stack(got).cpu().numpy(), torch.stack(want).cpu().numpy())
    assert dmax == 0, (dmax, same)


# the route shapes (u=3 720p and 1.5x, u=4 qHD), then per u: h and W off the
# kernel's band (16, 8 or 4 rows) and strip (64 columns) with W % 4 != 0
# (byte stores, per-element staging), W a multiple of 8 but not of 64
# (16-byte staging, a partial strip), and single rows or columns
CUDA_CASES = (
    [(3, (3, 720, 1280)), (3, (2, 37, 200)), (4, (2, 37, 200)), (5, (2, 37, 200)),
     (7, (2, 37, 200)), (8, (1, 1, 1)), (3, (3, 360, 640)), (4, (3, 540, 960))]
    + [(u, (2, 37, 201)) for u in range(1, 9)]
    + [(u, (2, 19, 136)) for u in range(1, 9)]
    + [(1, (1, 1, 5)), (3, (1, 1, 70)), (4, (2, 40, 1)), (6, (1, 9, 66)), (2, (1, 17, 3))]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("u,shape", CUDA_CASES)
def test_cuda_grid_kernel_matches_plain_version(u, shape, dtype):
    """On the card: K4 identical on every pixel to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_exact(_cuda_planes(u, shape, dtype), u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("u,shape", [(1, (2, 21, 136)), (3, (2, 21, 136)), (4, (3, 540, 960)),
                                     (8, (1, 13, 136))])
def test_cuda_grid_kernel_misaligned_planes(u, shape, dtype):
    """On the card: planes that start 2 (int16) or 4 (float32) bytes past a
    16-byte boundary at widths the 16-byte copies would take: the kernel
    stages them element by element, identical on every pixel to its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    _cuda_exact(_cuda_planes(u, shape, dtype, offset=1), u)


@pytest.mark.cuda
def test_cuda_grid_kernel_rejects_u_over_its_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    P = [torch.zeros((1, 2, 2), device="cuda") for _ in range(81)]
    with pytest.raises(ValueError, match="u <= 8"):
        cas_parity_grid_planes(P, 9, 0.2)
