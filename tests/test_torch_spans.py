"""The port's spans (vkresample_tpu_torch/utils/profiling.py::span) on the
CPU: one tree per call of a built pipeline under "vkr.call", every compute
op of the call inside a stage span, nothing reached in torch.profiler while
no profiler runs, and the same outputs traced or not."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vkresample_tpu_torch import Precision, UpscalePlan
from vkresample_tpu_torch.core import tuning
from vkresample_tpu_torch.fft import mxu_pipeline
from vkresample_tpu_torch.pipeline import upscale as tpipe
from vkresample_tpu_torch.utils import profiling

STAGES = {"vkr.layout", "vkr.precas", "vkr.precas.x", "vkr.precas.y", "vkr.codec", "vkr.cas"}
COMPUTE = {"aten::mm", "aten::bmm", "aten::matmul", "aten::einsum", "aten::mul", "aten::add",
           "aten::sub", "aten::clamp", "aten::round", "aten::copy_", "aten::_to_copy"}
LOW = 64  # a card's dense cap below the staged case's axes (tests/test_torch_tuning.py)

# (id, plan, planes_out, the cap of a card's row or None, the bank set the
# route reads, spans under vkr.call: layouts, x and y passes, codec calls
# inside vkr.precas)
ROUTES = [
    ("quad-p2", dict(h=64, w=128, precision=Precision.HALF), True, None, "rows", (1, 1, 6)),
    ("staged-quad-p2", dict(h=32, w=128, precision=Precision.HALF), True, LOW, "staged",
     (1, 1, 6)),
    ("rows-p2-woven", dict(h=32, w=96, precision=Precision.HALF), False, None, "rows",
     (3, 0, 3)),
    ("quad-p0", dict(h=64, w=128, precision=Precision.SINGLE), True, None, "rows", (1, 1, 0)),
]


@pytest.fixture
def route(request, monkeypatch):
    """(fn, img, counts) of one ROUTES entry; the staged case takes a card
    row with a low dense cap, the pipeline cache cleared around it."""
    _, kw, planes_out, cap, tag, counts = request.param
    if cap is not None:
        monkeypatch.setattr(tuning, "_row", lambda device: tuning.DeviceTuning(dense_max=cap))
    tpipe._build.cache_clear()
    plan = UpscalePlan(upscale=2.0, channels=3, **kw)
    assert mxu_pipeline.bank_set(tuning.plan_for(plan, "cpu")) == tag
    fn = tpipe.build_upscale(plan, "cpu", planes_out=planes_out, planar_out=planes_out)
    rng = np.random.default_rng(len(request.param[0]))
    img = torch.from_numpy(rng.integers(0, 256, (2, kw["h"], kw["w"], 3), np.uint8))
    yield fn, img, counts
    tpipe._build.cache_clear()


def _traced(fn, img):
    """(outputs, [(start, end, name, is a span)] of every CPU event) of one
    call under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn(img)
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.is_user_annotation())
           for e in p.profiler.kineto_results.events()]
    return out, sorted(evs, key=lambda e: (e[0], -e[1]))


def _inside(ev, span):
    return span[0] <= ev[0] and ev[1] <= span[1]


def _parent(ev, spans):
    """The innermost span that holds ev, or None."""
    return max((s for s in spans if s is not ev and _inside(ev, s)),
               key=lambda s: (s[0], -s[1]), default=None)


def _outputs(out):
    return [o.clone() for o in (out if isinstance(out, (tuple, list)) else (out,))]


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES], indirect=True)
def test_each_call_is_one_tree_of_stage_spans(route):
    fn, img, (layouts, xy, codecs) = route
    fn(img)  # the banks and any lazy set-up outside the trace
    _, evs = _traced(fn, img)
    spans = [e for e in evs if e[3] and e[2].startswith("vkr.")]
    assert {s[2] for s in spans} <= set(profiling.SPANS)
    (call,) = [s for s in spans if s[2] == "vkr.call"]
    assert all(_inside(s, call) for s in spans)
    parent = {s: _parent(s, spans) for s in spans if s is not call}
    names = lambda p: sorted(s[2] for s, q in parent.items() if q is p)  # noqa: E731
    assert names(call) == sorted(["vkr.layout"] * layouts + ["vkr.precas", "vkr.cas"])
    (precas,) = [s for s in spans if s[2] == "vkr.precas"]
    passes = [n for n in names(precas) if n != "vkr.codec"]
    assert passes == ["vkr.precas.x", "vkr.precas.y"] * xy
    assert sum(s[2] == "vkr.codec" and _inside(s, precas) for s in spans) == codecs
    for s, q in parent.items():
        if s[2] == "vkr.codec":  # in the transform, or the plain CAS's load on the CPU
            assert q[2] in ("vkr.precas", "vkr.precas.x", "vkr.precas.y", "vkr.cas")
    stages = [s for s in spans if s[2] in STAGES]
    ops = [e for e in evs if not e[3] and e[2] in COMPUTE and _inside(e, call)]
    assert ops
    for e in ops:
        assert any(_inside(e, s) for s in stages), e


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert all(profiling.span(n) is profiling._OFF for n in profiling.SPANS)
    tpipe._build.cache_clear()
    plan = UpscalePlan(h=64, w=128, upscale=2.0, precision=Precision.HALF)
    fn = tpipe.build_upscale(plan, "cpu", planes_out=True, planar_out=True)
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (64, 128, 3), np.uint8))
    assert len(fn(img)) == 4
    tpipe._build.cache_clear()


def test_under_a_profiler_a_span_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = profiling.span("vkr.call")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    assert profiling.span("vkr.call") is profiling._OFF


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES], indirect=True)
def test_outputs_are_the_same_traced_or_not(route):
    fn, img, _ = route
    plain = _outputs(fn(img))
    traced, _ = _traced(fn, img)
    assert all(torch.equal(a, b) for a, b in zip(plain, _outputs(traced)))
