"""Port fused rows CAS (K5), wrapper and plain version, against the JAX
package's Pallas kernel (interpret mode on the CPU), the woven CAS of the
woven image and the fp64 oracle CAS; and the integer u >= 3 rows route that
now runs it.

Tolerances: against the JAX kernels, <= 1 LSB and >= 99.9 % of pixels
identical (the same rsqrt blend in float32 with different operation fusion
can flip a truncation; the K2/K3 bar of test_torch_cas_woven.py).  Against
weave + woven CAS, bit-equal (the same arithmetic on the same values).
Against the fp64 oracle, <= 1 LSB."""
import numpy as np
import pytest
import torch

from vkresample_tpu_torch import Precision, UpscalePlan, upscale
from vkresample_tpu_torch.fft import dense
from vkresample_tpu_torch.ops import cas
from vkresample_tpu_torch.ops.cas_cuda import (
    cas_quantize,
    cas_quantize_reference,
    cas_quantize_rows_u,
    cas_quantize_rows_u_reference,
)
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe

MIN_IDENTICAL = 0.999
# (u, h, W): the JAX tests' geometries, and u = 4 (the u=4 route's u) where h
# is a multiple of the 16-row band with h >= 32 and W % 128 == 0, so the JAX
# kernel runs its Pallas body and not its weave fallback
JAX_CASES = [(2, 64, 128), (3, 48, 128), (4, 48, 128)]
ODD_CASES = [(4, 7, 37), (5, 7, 37), (3, 1, 1), (2, 37, 200), (3, 5, 202)]


def _pre_cas(shape, seed):
    """Pre-CAS values over [-0.1, 1.2): both clip branches and the
    negative side of |v| are exercised."""
    return np.random.default_rng(seed).random(shape, np.float32) * 1.3 - 0.1


def _rows_inputs(u, h, W, seed, C=2):
    return _pre_cas((C, h, W), seed), _pre_cas((C, h * (u - 1), W), seed + 1)


def _agree(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return d.max(), (d == 0).mean()


def _oracle_cas(v):
    v = np.asarray(v, np.float64)
    return np.stack([toracle.quantize_u8(toracle.cas_sharpen(c, 0.2, False)) for c in v])


@pytest.mark.parametrize("u,h,W", JAX_CASES)
def test_rows_plain_matches_jax_kernel_f32(u, h, W):
    """K5's plain version against JAX cas_quantize_rows_u (interpret), f32:
    the JAX kernel takes float32 only."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas_pallas import cas_quantize_rows_u as jk5

    U, O = _rows_inputs(u, h, W, seed=u + h)
    want = jk5(jnp.asarray(U), jnp.asarray(O), u, 0.2, block_rows=16, interpret=True)
    got = cas_quantize_rows_u_reference(torch.from_numpy(U), torch.from_numpy(O), u, 0.2)
    assert got.dtype == torch.uint8 and got.shape == (2, u * h, W)
    dmax, same = _agree(got.numpy(), want)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("u,h,W", JAX_CASES)
def test_rows_plain_matches_jax_woven_kernel_i16(u, h, W):
    """int16 Q2.14 U and O (the -p 2 route's storage): K5's plain version
    against JAX cas_quantize_pallas of the JAX row weave (interpret)."""
    import jax.numpy as jnp

    from vkresample_tpu.fft.dense import weave_rows as jweave_rows
    from vkresample_tpu.ops.cas import to_i16_storage as jst
    from vkresample_tpu.ops.cas_pallas import cas_quantize_pallas

    U, O = _rows_inputs(u, h, W, seed=2 * u + h)
    jU, jO = jst(jnp.asarray(U)), jst(jnp.asarray(O))
    tU, tO = cas.to_i16_storage(torch.from_numpy(U)), cas.to_i16_storage(torch.from_numpy(O))
    np.testing.assert_array_equal(tO.numpy(), np.asarray(jO))
    want = cas_quantize_pallas(jweave_rows(jU, jO, u), 0.2, block_rows=16, interpret=True)
    got = cas_quantize_rows_u_reference(tU, tO, u, 0.2)
    dmax, same = _agree(got.numpy(), want)
    assert dmax <= 1 and same >= MIN_IDENTICAL, (dmax, same)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("u,h,W", ODD_CASES)
def test_rows_plain_is_woven_cas_and_matches_oracle(u, h, W, dtype):
    """Any u >= 2, h, W >= 1: bit-equal to the woven CAS of the row-woven
    image, and within 1 LSB of the fp64 oracle's CAS of it."""
    U, O = (torch.from_numpy(a) for a in _rows_inputs(u, h, W, seed=u * h + W))
    if dtype == "int16":
        U, O = cas.to_i16_storage(U), cas.to_i16_storage(O)
    got = cas_quantize_rows_u_reference(U, O, u, 0.2)
    v = dense.weave_rows(U, O, u)
    np.testing.assert_array_equal(got.numpy(), cas_quantize_reference(v, 0.2).numpy())
    vf = cas.from_i16_storage(v) if dtype == "int16" else v
    assert _agree(got.numpy(), _oracle_cas(vf.numpy()))[0] <= 1


def test_rows_wrapper_on_cpu_uses_plain_version():
    """On CPU tensors the wrapper returns its plain version's output (leading
    dims kept) and launches nothing."""
    U = torch.from_numpy(_pre_cas((2, 3, 6, 20), seed=1))
    O = torch.from_numpy(_pre_cas((2, 3, 12, 20), seed=2))
    before = cas_quantize_rows_u.launches
    got = cas_quantize_rows_u(U, O, 3, 0.2)
    assert got.shape == (2, 3, 18, 20)
    assert torch.equal(got, cas_quantize_rows_u_reference(U, O, 3, 0.2))
    assert cas_quantize_rows_u.launches == before


def test_rows_wrapper_rejects_bad_inputs():
    U = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_quantize_rows_u(U, torch.zeros((1, 8, 16)), 3, 0.2)  # O needs 16 rows
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        cas_quantize_rows_u(U, torch.zeros((1, 16, 16), dtype=torch.int16), 3, 0.2)
    with pytest.raises(ValueError, match="integer u >= 2"):
        cas_quantize_rows_u(U, torch.zeros((1, 0, 16)), 1, 0.2)
    with pytest.raises(ValueError, match="integer u >= 2"):
        cas_quantize_rows_u(U, torch.zeros((1, 8, 16)), 2.5, 0.2)
    with pytest.raises(TypeError, match="int16 or float32"):
        cas_quantize_rows_u(U.double(), torch.zeros((1, 16, 16)).double(), 3, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        cas_quantize_rows_u(U, torch.zeros((1, 16, 16)).transpose(1, 2), 3, 0.2)


@pytest.mark.parametrize("prec", [Precision.SINGLE, Precision.HALF])
@pytest.mark.parametrize("u", [3, 4])
def test_u3_plus_route_runs_k5(monkeypatch, u, prec):
    """The integer u >= 3 rows route calls K5 (once per frame, with the
    route's U and O) and no woven CAS; its output stays within 1 LSB of
    the oracle."""
    calls = []

    def counting(U, O, uu, sharpen):
        calls.append((tuple(U.shape), tuple(O.shape), uu, U.dtype))
        return cas_quantize_rows_u(U, O, uu, sharpen)

    def no_woven(*a, **k):
        raise AssertionError("the u >= 3 rows route ran the woven CAS")

    monkeypatch.setattr(tpipe, "cas_quantize_rows_u", counting)
    monkeypatch.setattr(tpipe, "cas_quantize", no_woven)
    h, w = 16, 24
    plan = UpscalePlan(h=h, w=w, upscale=float(u), precision=prec)
    img = np.random.default_rng(u).integers(0, 256, (h, w, 3), np.uint8)
    out = upscale(img, u, plan=plan, device="cpu")
    dtype = torch.int16 if prec is Precision.HALF else torch.float32
    assert calls == [((3, h, u * w), (3, h * (u - 1), u * w), u, dtype)]
    want = toracle.upscale_oracle(img, plan)
    assert np.abs(out.numpy().astype(np.int32) - want).max() <= 1


# (u, h, W, misaligned inputs): the two route shapes; u = 2..8 and u = 11 with
# u*h and W off the kernel's 64-row band and 128-column strip; W % 4 != 0
# and W % 8 != 0 (byte stores, per-element staging where W * sizeof(T) %
# 16 != 0); single rows and columns; U, O or both one element (2 or 4
# bytes) past a 16-byte boundary, which takes the per-element staging form
CUDA_CASES = (
    [(3, 720, 3840, ""), (4, 540, 3840, ""), (3, 5, 202, "")]
    + [(u, 37, 200, "") for u in range(2, 9)]
    + [(3, 37, 131, ""), (4, 21, 202, ""), (5, 13, 132, ""), (2, 64, 136, ""),
       (11, 9, 66, ""), (3, 1, 1, ""), (2, 1, 70, ""), (4, 40, 1, ""), (6, 1, 129, "")]
    + [(3, 37, 200, "U"), (4, 21, 136, "O"), (2, 19, 264, "UO"), (4, 540, 3840, "UO")]
)


def _misaligned(t):
    """t as a contiguous view one element past the start of its buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("u,h,W,misaligned", CUDA_CASES)
def test_cuda_rows_kernel_matches_plain_and_woven(u, h, W, misaligned, dtype):
    """On the card: K5 equals its plain version and weave_rows + K3 on
    every pixel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    g = torch.Generator(device="cuda").manual_seed(u + h)
    U = torch.rand((3, h, W), generator=g, device="cuda") * 1.3 - 0.1
    O = torch.rand((3, h * (u - 1), W), generator=g, device="cuda") * 1.3 - 0.1
    if dtype == torch.int16:
        U, O = cas.to_i16_storage(U), cas.to_i16_storage(O)
    U = _misaligned(U) if "U" in misaligned else U
    O = _misaligned(O) if "O" in misaligned else O
    before = cas_quantize_rows_u.launches
    got = cas_quantize_rows_u(U, O, u, 0.2)
    torch.cuda.synchronize()
    assert cas_quantize_rows_u.launches == before + 1
    assert torch.equal(got, cas_quantize_rows_u_reference(U, O, u, 0.2))
    assert torch.equal(got, cas_quantize(dense.weave_rows(U, O, u), 0.2))
