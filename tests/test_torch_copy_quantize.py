"""Port copy-quantize probes (K10a copy_quantize_tile, K10b copy_quantize_mono,
K10c copy_quantize_rows: the woven CAS kernels' data movement with the CAS
taken out), wrappers and
plain version, against the JAX script's Pallas kernel
scripts/cas_split.py::copy_quantize (interpret mode on the CPU), the JAX
package's quantize_u8, and on the CAS-split frame (the A/B frame's woven
image, then one probe).

Tolerance: equal on every pixel.  The quantize is one float32 multiply, two
clamps and a truncation, the same operations in every version."""
import ast
import functools
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from vkresample_tpu_torch.ops.cas import quantize_u8
from vkresample_tpu_torch.ops.quantize_cuda import (
    copy_quantize,
    copy_quantize_mono,
    copy_quantize_reference,
    copy_quantize_rows,
    copy_quantize_tile,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORMS = [("tile", 128), ("mono", 1), ("mono", 7), ("mono", 128), ("rows", 128)]


def _pre_cas(shape, seed):
    """Values over [-0.1, 1.2): both clamp branches are hit."""
    return np.random.default_rng(seed).random(shape, np.float32) * 1.3 - 0.1


def _jax_k10():
    """scripts/cas_split.py::copy_quantize with pallas_call in interpret
    mode.  The script runs its benchmark at import, so only its top-level
    nodes before the first tuple assignment (``h, w = 1024, 2048``) run,
    and `pl` in their namespace is a copy of the Pallas module whose
    pallas_call interprets."""
    from jax.experimental import pallas as pl

    path = os.path.join(ROOT, "scripts", "cas_split.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    head = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple):
            break
        head.append(node)
    ns = {"__name__": "cas_split"}
    saved = list(sys.path)
    try:
        exec(compile(ast.Module(body=head, type_ignores=[]), path, "exec"), ns)
    finally:
        sys.path[:] = saved  # the script puts "." first
    interp = types.ModuleType("pallas_interpret")
    interp.__dict__.update(ns["pl"].__dict__)
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = interp
    return ns["copy_quantize"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# against the JAX kernel and quantize_u8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bh", [((2, 64, 256), 16), ((3, 256, 512), 128)])
def test_plain_matches_jax_k10(shape, bh):
    """The plain version (through both wrappers on CPU tensors) against JAX
    K10 in interpret mode, at shapes where K10 writes every row (H a
    multiple of bh, H >= bh + 16): equal on every pixel."""
    import jax.numpy as jnp

    v = _pre_cas(shape, seed=sum(shape))
    want = np.asarray(_jax_k10()(jnp.asarray(v), bh=bh))
    assert want.dtype == np.uint8 and want.shape == shape
    tv = torch.from_numpy(v)
    np.testing.assert_array_equal(copy_quantize_reference(tv).numpy(), want)
    np.testing.assert_array_equal(copy_quantize_tile(tv).numpy(), want)
    np.testing.assert_array_equal(copy_quantize_mono(tv, bh).numpy(), want)
    np.testing.assert_array_equal(copy_quantize_rows(tv).numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 37, 201)])
def test_plain_matches_jax_quantize_u8(shape):
    """Odd shapes, which the TPU kernel does not take: every form equals
    the JAX package's quantize_u8 on every pixel."""
    import jax.numpy as jnp

    from vkresample_tpu.ops.cas import quantize_u8 as jquantize_u8

    v = _pre_cas(shape, seed=3 + sum(shape))
    want = np.asarray(jquantize_u8(jnp.asarray(v)))
    assert (v < 0).any() or shape == (1, 1, 1)
    for form, bh in FORMS:
        got = copy_quantize(torch.from_numpy(v), form, bh)
        assert got.dtype == torch.uint8 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{form} bh={bh}")


def test_clamp_branches_and_truncation():
    """Below 0, above 1 and between: clamp to 0 and 255, truncate toward 0,
    as the port's and the JAX quantize_u8 do."""
    v = torch.tensor([[[-0.5, 0.0, 0.5, 0.999, 1.0, 1.2, 2.5 / 255.0]]])
    want = torch.tensor([[[0, 0, 127, 254, 255, 255, 2]]], dtype=torch.uint8)
    for form, bh in FORMS:
        assert torch.equal(copy_quantize(v, form, bh), want)
    assert torch.equal(quantize_u8(v), want)


# ---------------------------------------------------------------------------
# wrapper rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int16, torch.float64, torch.uint8])
def test_wrappers_take_float32_only(dtype):
    v = torch.zeros((1, 8, 16), dtype=dtype)
    for fn in (copy_quantize_reference, copy_quantize_tile, copy_quantize_mono,
               copy_quantize_rows, lambda t: copy_quantize(t, "mono", 32)):
        with pytest.raises(TypeError, match="float32"):
            fn(v)


def test_wrappers_reject_bad_inputs():
    nc = torch.zeros((1, 16, 8)).transpose(1, 2)
    for fn in (copy_quantize_tile, copy_quantize_mono, copy_quantize_rows):
        with pytest.raises(ValueError, match="contiguous"):
            fn(nc)
    for bh in (0, -1, 2.5):
        for form in ("tile", "mono", "rows"):
            with pytest.raises(ValueError, match="block_rows"):
                copy_quantize(torch.zeros((1, 8, 16)), form, bh)
    with pytest.raises(ValueError, match="form"):
        copy_quantize(torch.zeros((1, 8, 16)), "band")


@pytest.mark.parametrize("shape,bh", [((1, 300, 70), 1), ((1, 300, 70), 193),
                                      ((2, 37, 201), 1000)])
def test_mono_takes_any_block_rows(shape, bh):
    """K10b's segment height has no cap: bh 1, past the first design's 192
    rows and past H each give the plain version on a CPU tensor, and
    launch nothing."""
    v = torch.from_numpy(_pre_cas(shape, seed=43 + bh))
    before = copy_quantize_mono.launches
    assert torch.equal(copy_quantize_mono(v, bh), copy_quantize_reference(v))
    assert copy_quantize_mono.launches == before


@pytest.mark.parametrize("bh", [0, -1, 1.5])
def test_mono_block_rows_is_a_positive_integer(bh):
    with pytest.raises(ValueError, match="block_rows"):
        copy_quantize_mono(torch.zeros((1, 8, 16)), bh)


def test_wrappers_on_cpu_use_plain_version_and_count_nothing():
    """On CPU tensors every form returns the plain version (leading dims
    kept) and launches nothing; each form has its own counter."""
    v = torch.from_numpy(_pre_cas((2, 3, 10, 20), seed=19))
    counters = (copy_quantize_tile, copy_quantize_mono, copy_quantize_rows)
    before = [fn.launches for fn in counters]
    want = copy_quantize_reference(v)
    assert want.shape == v.shape
    for form, bh in FORMS:
        assert torch.equal(copy_quantize(v, form, bh), want)
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 37, 201), (2, 3, 65, 130)])
def test_rows_wrapper_plain_path_and_argument_errors(shape):
    """K10c on CPU tensors: the plain version (leading dims kept), no launch
    counted; float32 only, contiguous only."""
    v = torch.from_numpy(_pre_cas(shape, seed=29 + sum(shape)))
    before = copy_quantize_rows.launches
    got = copy_quantize_rows(v)
    assert got.dtype == torch.uint8 and got.shape == shape
    assert torch.equal(got, copy_quantize_reference(v))
    assert torch.equal(got, copy_quantize(v, "rows"))
    assert copy_quantize_rows.launches == before
    with pytest.raises(TypeError, match="float32"):
        copy_quantize_rows(v.to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        copy_quantize_rows(torch.zeros(shape[:-2] + (16, 8)).transpose(-1, -2))
    with pytest.raises(ValueError, match="rows, cols"):
        copy_quantize_rows(v.reshape(-1))


# ---------------------------------------------------------------------------
# the CAS-split frame
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kid,bh", [("K10a", None), ("K10b", 64), ("K10b", 5), ("K10c", None)])
def test_cas_split_frame_is_quantize_of_the_woven_image(kid, bh):
    """chip_smoke's CAS-split frame on the CPU at a small u=2 -p 2 plan
    equals quantize_u8(weave_rows(r2c_rows(...))) on every pixel, and the
    JAX script's frame (JAX r2c_rows at HIGHEST, weave_rows, K10 in
    interpret mode) within 1 LSB: the GEMMs sum in another order."""
    import jax
    import jax.numpy as jnp

    from vkresample_tpu.core.config import Engine as JEngine
    from vkresample_tpu.core.config import Precision as JPrecision
    from vkresample_tpu.core.plan import UpscalePlan as JPlan
    from vkresample_tpu.fft import dense as jdense
    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu_torch import Engine, Precision, UpscalePlan
    from vkresample_tpu_torch.fft import dense
    from vkresample_tpu_torch.pipeline.upscale import make_device_banks

    h, w = 64, 128
    img = np.random.default_rng(23).integers(0, 256, (h, w, 3), np.uint8)
    plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF)
    got = _chip_smoke().cas_split_fn(plan, "cpu", kid, bh)(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.shape == (3, 2 * h, 2 * w)

    banks = make_device_banks(plan, Engine.MXU, "cpu", planes_out=False)
    U, O = dense.r2c_rows(torch.from_numpy(img).permute(2, 0, 1).contiguous(), banks)
    assert torch.equal(got, quantize_u8(dense.weave_rows(U, O, 2)))

    jplan = JPlan(h=h, w=w, upscale=2.0, precision=JPrecision.HALF, engine=JEngine.MXU)
    jU, jO = jdense.r2c_rows(jnp.moveaxis(jnp.asarray(img), -1, 0),
                             mxu_pipeline.make_dense_banks(jplan), jax.lax.Precision.HIGHEST)
    want = np.asarray(_jax_k10()(jdense.weave_rows(jU, jO, 2), bh=32))
    assert np.abs(got.numpy().astype(np.int16) - want.astype(np.int16)).max() <= 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 201), (3, 256, 512), (1, 1, 1), (3, 2048, 4096),
                                   (2, 64, 4100), (2, 33, 4097), (3, 1, 4096), (2, 300, 1),
                                   (2, 129, 256), (24, 512, 1024)])
def test_cuda_copy_quantize_kernels_match_plain_version(shape):
    """On the card: K10a and K10b (bh 1, 7, 32, 64, 128, 1000 and past H)
    equal the plain version on every pixel, one launch each on their own
    counter, at partial strips with W % 4 == 0 and != 0, H = 1, W = 1, H
    one row past a segment multiple and 24 planes; K10b also on a view of
    the image one float off a 16-byte boundary (its per-element copy
    form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    v = torch.rand(shape, generator=g, device="cuda") * 1.3 - 0.1
    buf = torch.empty(v.numel() + 1, device="cuda")
    buf[1:].copy_(v.reshape(-1))
    off = buf[1:].view(shape)
    want = copy_quantize_reference(v)
    before = copy_quantize_tile.launches
    assert torch.equal(copy_quantize_tile(v), want)
    assert copy_quantize_tile.launches == before + 1
    for bh in (1, 7, 32, 64, 128, 1000, shape[1] + 5):
        before = (copy_quantize_tile.launches, copy_quantize_mono.launches)
        got = copy_quantize_mono(v, bh)
        assert copy_quantize_mono.staging == ("bulk" if shape[-1] % 4 == 0 else "per element")
        got_off = copy_quantize_mono(off, bh)
        assert copy_quantize_mono.staging == "per element"
        torch.cuda.synchronize()
        assert (copy_quantize_tile.launches, copy_quantize_mono.launches) == (
            before[0], before[1] + 2)
        assert torch.equal(got, want), bh
        assert torch.equal(got_off, want), bh


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((2, 37, 201), 0), ((3, 256, 512), 0), ((1, 1, 1), 0),
                                          ((2, 65, 131), 0), ((2, 40, 1), 0),
                                          ((3, 2048, 4096), 0), ((2, 37, 200), 1),
                                          ((3, 2048, 4096), 1)])
def test_cuda_copy_quantize_rows_kernel_matches_plain_version(shape, offset):
    """On the card: K10c equals the plain version on every pixel, off the
    kernel's band and strip edges, at odd widths, single rows and columns,
    the CAS-split frame's woven shape, and on an image one element past a
    16-byte boundary (the per-element staging form); one launch each on its
    own counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + offset)
    buf = torch.rand(int(np.prod(shape)) + offset, generator=g, device="cuda") * 1.3 - 0.1
    v = buf[offset:].view(shape)
    counters = (copy_quantize_tile, copy_quantize_mono, copy_quantize_rows)
    before = [fn.launches for fn in counters]
    got = copy_quantize_rows(v)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [before[0], before[1], before[2] + 1]
    assert torch.equal(got, copy_quantize_reference(v))
