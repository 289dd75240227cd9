"""The rows route + K5 at integer u = 3 (fft/dense.py::r2c_rows ->
ops/cas_cuda.py::cas_quantize_rows_u, K5's plain version on the CPU), as
the benchmark cell u3-720p.batch8 runs it: build_batched_upscale on
2-frame batches against vkbench/reference.py, the benchmark's plain
float64 reference, on its seeded frames (vkbench/inputs.py)."""
import os
import sys

import pytest
import torch

from vkresample_tpu_torch import Precision, UpscalePlan
from vkresample_tpu_torch.core import tuning
from vkresample_tpu_torch.fft import dense, mxu_pipeline
from vkresample_tpu_torch.pipeline import upscale as tpipe
from vkresample_tpu_torch.pipeline.batched import build_batched_upscale

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vkbench import check, inputs, reference  # noqa: E402

H100 = tuning.DeviceTuning(dense_max=4608, dense_tier="fft")  # core/tuning.py's row
CONFIG = {"upscale": 3.0, "r2c": True, "sharpen": 0.2}
SEED = 2**31 + 27
# The port's bar, as the JAX package's: at most 1 uint8 step from the
# float64 reference.  The fp32 GEMMs and, at -p 2, the Q2.14 storage of
# the pre-CAS image (a step of 2**-14, about 1/64 of a uint8 step) move a
# value by far less than a step, so it crosses at most one quantization
# edge; e4m3 storage (the control) moves it by tens of steps.
MAX_LSB = 1
SIZES = [(24, 40), (36, 64)]  # 7-smooth, with outputs 72x120 and 108x192


def _frames(h, w):
    return inputs.make_frames(SEED, 0, 2, h, w, 3, "cpu")


@pytest.mark.parametrize("precision", [Precision.HALF, Precision.SINGLE], ids=["p2", "p0"])
@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_u3_batches_are_within_one_lsb_of_the_reference(h, w, precision):
    plan = UpscalePlan(h=h, w=w, upscale=3.0, precision=precision, channels=3)
    assert mxu_pipeline.bank_set(plan) == "rows"
    frames = _frames(h, w)
    got = build_batched_upscale(plan, "cpu", planar_out=True)(frames)
    want = reference.upscale_frames(frames, CONFIG)
    gap, _, _ = check.compare(got, want)
    assert gap <= MAX_LSB


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_the_control_in_the_ports_place_fails_the_bound(h, w):
    frames = _frames(h, w)
    got = reference.upscale_frames(frames, CONFIG, store=reference.control_store)
    gap, _, _ = check.compare(got, reference.upscale_frames(frames, CONFIG))
    assert gap > MAX_LSB


def test_the_720p_plan_keeps_the_rows_route_on_the_h100():
    """1280x720 -> 3840x2160 at -p 2 under the H100's row: the dense fp32
    GEMMs + K5 with a woven output, neither the cuFFT form nor the big grid
    (the plan only; nothing is computed)."""
    plan = tuning.with_row(UpscalePlan(h=720, w=1280, upscale=3.0, precision=Precision.HALF,
                                       channels=3), H100)
    assert (plan.H, plan.W) == (2160, 3840)
    assert mxu_pipeline.bank_set(plan) == "rows"
    assert tpipe.planes_format(plan) is None
    assert not mxu_pipeline.fft_tier_selected(plan)
    assert not mxu_pipeline.above_cap(plan)


def test_each_call_counts_one_rows_call():
    plan = UpscalePlan(h=24, w=40, upscale=3.0, precision=Precision.HALF, channels=3)
    fn = build_batched_upscale(plan, "cpu", planar_out=True)
    frames = _frames(24, 40)
    fn(frames)
    before = dense.r2c_rows.calls
    fn(frames)
    assert dense.r2c_rows.calls == before + 1  # one call a batch, whatever its frames
    fn(frames[:1])
    assert dense.r2c_rows.calls == before + 2
