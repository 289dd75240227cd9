"""The port pins full-fp32 GEMMs per call, not per process: a built pipeline
and chip_smoke's frame functions run every GEMM under
pipeline/upscale.py::fp32_matmul, whatever TF32 setting the caller chose,
and leave the caller's settings as they were, also when a frame raises;
building a pipeline changes no setting.

On the CPU the settings cannot change a result, so the tests read them
where they matter: a torch-function mode records the settings at the
dispatch of every GEMM (torch.matmul, @, einsum and friends).  On the card
a cuda-marked test runs the flagship -p 0 frame under the caller's
set_float32_matmul_precision("high") and holds it to <= 1 LSB of the fp64
oracle, the JAX package's bar."""
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from vkresample_tpu_torch import Precision, UpscalePlan, build_upscale
from vkresample_tpu_torch.oracle import numpy_ref as toracle
from vkresample_tpu_torch.pipeline import upscale as tpipe
from vkresample_tpu_torch.pipeline.upscale import fp32_matmul

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
NEW_API = hasattr(torch.backends.cuda.matmul, "fp32_precision")
GEMMS = {"matmul", "__matmul__", "__rmatmul__", "einsum", "mm", "bmm", "addmm", "baddbmm",
         "tensordot"}


def _settings():
    """The TF32 settings: the legacy matmul precision and the per-backend
    fp32_precision values (or, on an older torch, cudnn.allow_tf32)."""
    b = torch.backends
    if NEW_API:
        return (torch.get_float32_matmul_precision(), b.cuda.matmul.fp32_precision,
                b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision)
    return torch.get_float32_matmul_precision(), b.cudnn.allow_tf32


FP32 = ("highest", "ieee", "ieee", "ieee") if NEW_API else ("highest", False)


def _set(state):
    b = torch.backends
    torch.set_float32_matmul_precision(state[0])
    if NEW_API:
        b.cuda.matmul.fp32_precision, b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision = (
            state[1:])
    else:
        b.cudnn.allow_tf32 = state[1]


@pytest.fixture
def caller_tf32():
    """The caller turns TF32 on the common way; the settings the process had
    come back after the test."""
    before = _settings()
    torch.set_float32_matmul_precision("high")
    try:
        yield _settings()
    finally:
        _set(before)


class GemmRecorder(TorchFunctionMode):
    """Records the TF32 settings at the dispatch of every GEMM."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in GEMMS:
            self.seen.append((func.__name__, _settings()))
        return func(*args, **(kwargs or {}))


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw,planes_out", [
    (dict(h=16, w=128, upscale=2.0), True),                       # quad
    (dict(h=16, w=40, upscale=2.0, precision=Precision.HALF), False),  # rows, woven
    (dict(h=12, w=20, upscale=3.0), False),                       # rows + K5
    (dict(h=16, w=24, upscale=1.5), False),                       # chain
    (dict(h=64, w=128, upscale=2.0, r2c=False), True),            # c2c grid
    (dict(h=8, w=12, upscale=2.5, r2c=False), False),             # c2c chain
])
def test_pipeline_gemms_run_in_fp32_under_callers_tf32(caller_tf32, kw, planes_out):
    """After set_float32_matmul_precision("high"), building a pipeline
    leaves the caller's settings alone, every GEMM of a frame sees full
    fp32 at dispatch, and the caller's settings are back after the call."""
    plan = UpscalePlan(sharpen=0.17, **kw)  # a plan no other test builds
    fn = build_upscale(plan, "cpu", planes_out=planes_out)
    assert _settings() == caller_tf32
    with GemmRecorder() as rec:
        fn(_img(plan.h, plan.w, seed=plan.w))
    assert rec.seen, "the frame ran no GEMM"
    assert {state for _, state in rec.seen} == {FP32}, rec.seen[:3]
    assert _settings() == caller_tf32


def test_settings_restored_when_a_frame_raises(caller_tf32, monkeypatch):
    """A frame that raises, before the GEMMs or inside them, leaves the
    caller's settings as they were."""
    plan = UpscalePlan(h=16, w=128, upscale=2.0, sharpen=0.16)
    fn = build_upscale(plan, "cpu", planes_out=True)
    with pytest.raises(ValueError, match="does not match plan"):
        fn(_img(16, 64, seed=1))
    assert _settings() == caller_tf32

    def boom(*args, **kw):
        assert _settings() == FP32
        raise RuntimeError("inside the transform")

    monkeypatch.setattr(tpipe.dense, "r2c_quad", boom)
    with pytest.raises(RuntimeError, match="inside the transform"):
        fn(_img(16, 128, seed=2))
    assert _settings() == caller_tf32


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_fp32_matmul_restores_every_setting(precision):
    """Inside: full fp32 everywhere.  After, normally or by an exception:
    exactly the settings before, including per-backend values that differ
    from what the legacy precision implies."""
    before = _settings()
    try:
        torch.set_float32_matmul_precision(precision)
        if NEW_API:
            torch.backends.cudnn.conv.fp32_precision = "tf32"
            torch.backends.cudnn.rnn.fp32_precision = "ieee"
        caller = _settings()
        with fp32_matmul():
            assert _settings() == FP32
        assert _settings() == caller
        with pytest.raises(KeyError):
            with fp32_matmul():
                assert _settings() == FP32
                raise KeyError("x")
        assert _settings() == caller
    finally:
        _set(before)


@pytest.mark.parametrize("run", ["fused y K8", "cas ab K7", "cas split K10a"])
def test_chip_smoke_frames_run_in_fp32(caller_tf32, run):
    """chip_smoke's frame functions outside the pipeline (fused y, the
    woven-CAS A/B and CAS-split frames, which scripts/torch_route_profile.py
    and scripts/torch_cas_split.py also time) pin fp32 for their GEMMs."""
    smoke = _chip_smoke()
    plan = UpscalePlan(h=16, w=40, upscale=2.0, precision=Precision.HALF)
    make = {"fused y K8": lambda: smoke.fused_y_fn(plan, "cpu", "K8"),
            "cas ab K7": lambda: smoke.cas_ab_fn(plan, "cpu", "K7", 8),
            "cas split K10a": lambda: smoke.cas_split_fn(plan, "cpu", "K10a", None)}[run]
    frame = make()
    with GemmRecorder() as rec:
        frame(torch.from_numpy(_img(16, 40, seed=5)))
    assert rec.seen and {state for _, state in rec.seen} == {FP32}
    assert _settings() == caller_tf32


@pytest.mark.cuda
def test_cuda_flagship_stays_fp32_under_callers_tf32(caller_tf32):
    """On the card: the flagship quad -p 0 frame (2048x1024 -> 4096x2048),
    built and run after set_float32_matmul_precision("high"), stays within
    1 LSB of the fp64 oracle, and the caller's setting is unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vkresample_tpu_torch.io.png import weave4_host

    plan = UpscalePlan(h=1024, w=2048, upscale=2.0)
    img = _img(1024, 2048, seed=6)
    planes = build_upscale(plan, planes_out=True)(img)
    torch.cuda.synchronize()
    assert _settings() == caller_tf32
    got = np.moveaxis(weave4_host(*[p.cpu().numpy() for p in planes]), 0, -1)
    want = toracle.upscale_oracle(img, plan)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
