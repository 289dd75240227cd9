"""The readers of the port's spans (vkbench/spans.py and the port_*
metrics) on synthetic kineto events, as test_trace_reading builds them:
hand-computed values, spans that cross the window's edges, and nothing
read from a trace without a vkr.call span."""
import os
import sys

import pytest

from conftest import ROOT
from test_vkbench_harness import _Ev

sys.path.insert(0, ROOT)

from vkbench import harness, spans  # noqa: E402
from vkbench.trace import Trace  # noqa: E402

CPU, GPU = "DeviceType.CPU", "DeviceType.CUDA"
METRICS = ["port_idle_pct.realtime", "port_dispatch_ms_p95.realtime", "port_dispatch_pct.batch"]


def _reader(name):
    return harness.load_module(os.path.join(ROOT, "vkbench", "metrics", name + ".py"))


def _events(with_port_spans=True):
    """A 100 us window; calls of the port at [-5, 10] us (crosses the
    start), [20, 34] and [90, 110] (crosses the end), one at [120, 130]
    outside it; device operations at [2, 6], [25, 40] and [95, 99] us."""
    ev = [
        _Ev("vkbench.window", CPU, 0, 100_000, ua=True),
        _Ev("vkbench.call", CPU, 19_000, 16_000, ua=True),
        _Ev("k1", GPU, 2_000, 4_000, corr=1),
        _Ev("k2", GPU, 25_000, 15_000, corr=2),
        _Ev("k3", GPU, 95_000, 4_000, corr=3),
    ]
    if with_port_spans:
        ev += [
            _Ev("vkr.call", CPU, -5_000, 15_000, ua=True),
            _Ev("vkr.call", CPU, 20_000, 14_000, ua=True),
            _Ev("vkr.precas", CPU, 21_000, 8_000, ua=True),  # a stage: not a call
            _Ev("vkr.call", GPU, 20_000, 30_000, ua=True),  # the device's copy: not read
            _Ev("vkr.call", CPU, 90_000, 20_000, ua=True),
            _Ev("vkr.call", CPU, 120_000, 10_000, ua=True),
        ]
    return ev


def test_port_calls_are_clipped_to_the_window():
    t = Trace(_events())
    assert spans.port_calls(t) == [(0, 10_000), (20_000, 34_000), (90_000, 100_000)]
    # calls 34 us; the device busy in them 4 + 9 + 4 us
    assert spans.idle_in_calls_ns(t) == 17_000
    assert spans.union([(0, 5), (3, 8), (9, 12)]) == [[0, 8], [9, 12]]
    assert spans.overlap_ns([[0, 8], [9, 12]], [[5, 10], [11, 20]]) == 3 + 1 + 1


@pytest.mark.parametrize("name,want", [
    ("port_idle_pct.realtime", 17.0),              # 17 of 100 us
    ("port_dispatch_ms_p95.realtime", 0.0136),     # 0.010, 0.010, 0.014 ms: 0.010 + 0.9 x 0.004
    ("port_dispatch_pct.batch", 34.0),             # 10 + 14 + 10 of 100 us
])
def test_port_metrics_read_hand_computed_values(name, want):
    t = Trace(_events())
    run = harness.Run(trace=t, frames=3)
    assert _reader(name).read(run) == pytest.approx(want)
    idle = _reader("device_idle_pct.realtime").read(run)
    assert idle == pytest.approx(77.0) and _reader("port_idle_pct.realtime").read(run) <= idle


@pytest.mark.parametrize("name", METRICS)
def test_port_metrics_read_nothing_without_the_span(name):
    """A program without the span (the parent of the change that added it)
    reads None, not zero, and an untraced run too."""
    assert _reader(name).read(harness.Run(trace=Trace(_events(False)), frames=3)) is None
    assert _reader(name).read(harness.Run(trace=None, frames=3)) is None
