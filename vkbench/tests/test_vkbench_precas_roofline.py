"""precas_roofline.batch on the CPU: the pre-CAS work counted by hand for
the four batch8 configurations, which bound binds, nothing read without a
trace, peaks or pre-CAS kernels, and a synthetic trace read through it."""
import json
import math
import os
import sys

import pytest

from conftest import ROOT
from test_vkbench_harness import _Ev

sys.path.insert(0, ROOT)

from vkbench import harness  # noqa: E402
from vkbench.trace import Trace  # noqa: E402

SPEC = harness.load_spec(ROOT)
MOD = harness.load_module(os.path.join(ROOT, "vkbench", "metrics", "precas_roofline.batch.py"))
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12}  # H100 SXM, vkbench/peaks.py
H100 = "NVIDIA H100 80GB HBM3"


def _config(name):
    conf = {c["name"]: c for c in SPEC["configs"]}[name]
    with open(os.path.join(ROOT, conf["file"])) as f:
        return json.load(f)


# (config, h w, H W, least time in us): 3 channels, -p 2 (2 B a stored value)
BATCH8 = [
    ("hd720-1280x720-u3-p2", 1280 * 720, 3840 * 2160, 23.38),
    ("flagship-2048x1024-u2-p2", 2048 * 1024, 4096 * 2048, 26.52),
    ("hd-1920x1080-u2-p2", 1920 * 1080, 3840 * 2160, 26.21),
    ("uhd-3840x2160-u2-p2", 3840 * 2160, 7680 * 4320, 114.12),
]


@pytest.mark.parametrize("name,n_in,n_out,least_us", BATCH8, ids=[b[0] for b in BATCH8])
def test_work_is_the_real_ffts_count_and_the_operations_bind(name, n_in, n_out, least_us):
    config = _config(name)
    ops = 3 * 2.5 * (n_in * math.log2(n_in) + n_out * math.log2(n_out))
    nbytes = 3 * n_in + 3 * n_out * 2
    assert MOD.work(config) == (nbytes, pytest.approx(ops))
    assert ops / PEAKS["fp32_flops"] > nbytes / PEAKS["hbm_bytes_per_s"]  # operations bind
    assert MOD.least_seconds(config, PEAKS) == pytest.approx(ops / PEAKS["fp32_flops"])
    assert MOD.least_seconds(config, PEAKS) * 1e6 == pytest.approx(least_us, abs=0.01)


def test_at_p0_the_bytes_bind():
    config = dict(_config("flagship-2048x1024-u2-p2"), precision="SINGLE")
    nbytes, ops = MOD.work(config)
    assert nbytes == 3 * 2048 * 1024 + 3 * 4096 * 2048 * 4
    assert MOD.least_seconds(config, PEAKS) == pytest.approx(nbytes / PEAKS["hbm_bytes_per_s"])


CPU, GPU = "DeviceType.CPU", "DeviceType.CUDA"


def _trace(*device_ops):
    return Trace([_Ev("vkbench.window", CPU, 0, 10_000_000, ua=True)]
                 + [_Ev(n, GPU, s, d) for n, s, d in device_ops])


def _run(trace, frames=8, card=H100, name="hd720-1280x720-u3-p2"):
    return harness.Run(config=_config(name), frames=frames, card=card, trace=trace)


def test_a_synthetic_trace_reads_the_pre_cas_kernels_alone():
    t = _trace(("ampere_sgemm_128x64_nn", 0, 6_000_000),  # the x and y GEMMs: 6 ms
               ("void cas_rows_kernel<3, short>(...)", 6_000_000, 700_000),  # K5: CAS, left out
               ("Memcpy DtoD (Device -> Device)", 6_700_000, 300_000),  # a copy, left out
               ("void at::native::elementwise_kernel<128, 2>(...)", 7_000_000, 2_000_000))
    least = MOD.least_seconds(_config("hd720-1280x720-u3-p2"), PEAKS)
    assert MOD.read(_run(t)) == pytest.approx(100.0 * 8 * least / 8e-3)
    assert 0 < MOD.read(_run(t)) < 100


def test_nothing_is_read_without_a_trace_peaks_frames_or_pre_cas_kernels():
    t = _trace(("ampere_sgemm_128x64_nn", 0, 6_000_000))
    assert MOD.read(_run(None)) is None
    assert MOD.read(_run(t, card="cpu")) is None
    assert MOD.read(_run(t, frames=0)) is None
    assert MOD.read(_run(_trace())) is None
    cas_only = _trace(("void cas_grid_kernel<2, short>(...)", 0, 500_000),
                      ("Memcpy HtoD (Pinned -> Device)", 500_000, 100_000))
    assert MOD.read(_run(cas_only)) is None
