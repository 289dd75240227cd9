"""The check against its control and against planted faults, at a size a
test run holds (the readings at the cells' sizes come from calibrate.py on
the card; PERF.md keeps them)."""
import sys

import pytest
import torch

from conftest import ROOT, TINY_CELL, WOVEN_CELL

sys.path.insert(0, ROOT)

from vkbench import check, harness, inputs, sut  # noqa: E402
from vkbench import reference as REF  # noqa: E402
CONFIGS = [harness.Cell(ROOT, w["name"]).config for w in harness.load_spec(ROOT)["workloads"]]


@pytest.mark.parametrize("config", CONFIGS, ids=[c["name"] for c in CONFIGS])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 1])
def test_the_control_comes_out_not_correct(config, seed):
    frames = inputs.make_frames(seed, 0, 2, 64, 128, config["channels"], "cpu")
    tally = check.Tally()
    tally.add(REF.upscale_frames(frames, config, store=REF.control_store),
              REF.upscale_frames(frames, config))
    assert not check.judge(tally.numbers(), config["check"]), tally.numbers()


def _planes(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _stale(fn):
    last = {}

    def run(x):
        out = fn(x)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return run


def _half_batch(fn):
    def run(x):
        out = _planes(fn(x[: x.shape[0] // 2]))
        return tuple(torch.cat([p, p]) for p in out)
    return run


def _altered(fn):
    def run(x):
        out = _planes(fn(x))
        p = out[0].clone()
        p.view(-1)[p.numel() // 3] += 128
        return (p,) + tuple(out[1:])
    return run


@pytest.mark.parametrize("cell,fmt", [(TINY_CELL, "quad"), (WOVEN_CELL, None)],
                         ids=["quad", "woven"])
@pytest.mark.parametrize("fault", [None, _stale, _half_batch, _altered],
                         ids=["sound", "state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_in_the_timed_path_comes_out_not_correct(tiny_root, cell, fmt, fault):
    def build(config, device):
        fn, got_fmt = sut.build(config, device)
        assert got_fmt == fmt  # the layout this case is meant to check
        return (fn if fault is None else fault(fn)), got_fmt

    res = harness.run_cell(tiny_root, cell, 2**31 + 99, 1, False, "cpu", 0.0,
                           build=build, log=lambda s: None)
    assert res["correct"] is (fault is None), res["check"]
    assert (res["failed"] > 0) is (fault is not None)
