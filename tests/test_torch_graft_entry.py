"""The port's graft entry points (vkresample_tpu_torch/graft_entry.py) on
the CPU: entry()'s flagship step on a seeded 256x512 frame against the
root __graft_entry__.entry() step jitted by JAX (the same banks, carried
across with weights.banks_from_jax) and the fp64 oracle, both within 1
LSB; dryrun_multichip(2) on two CPU entries and two gloo ranks; and both
raising without a card when no device is named."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vkresample_tpu_torch import graft_entry
from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle
from vkresample_tpu_torch.weights import banks_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as jge  # noqa: E402

SPAWN_TIMEOUT_S = 120


def _maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


@pytest.fixture(scope="module")
def flagship():
    """(the seeded frame, the port's output, JAX's output, the oracle)."""
    fn, (img, banks) = graft_entry.entry(device="cpu")
    plan = fn.keywords["plan"]
    frame = np.random.default_rng(20261018).integers(0, 256, (plan.h, plan.w, 3), np.uint8)
    jfn, (jimg, jbanks) = jge.entry()
    assert jimg.shape == tuple(img.shape) == frame.shape
    want_jax = np.asarray(jax.jit(jfn)(frame, jbanks))
    got = fn(torch.from_numpy(frame), banks_from_jax(jbanks, "cpu")).numpy()
    return frame, got, want_jax, upscale_oracle(frame, plan)


def test_entry_returns_the_flagship_step_on_its_example_args():
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].dtype == torch.uint8 and args[0].device.type == "cpu"
    out = fn(*args)
    assert out.shape == (512, 1024, 3) and out.dtype == torch.uint8
    assert int(out.max()) == 0  # a zero frame stays zero


def test_entry_matches_the_jax_entry_step(flagship):
    frame, got, want_jax, _ = flagship
    assert got.shape == want_jax.shape == (512, 1024, 3) and got.dtype == np.uint8
    assert _maxdiff(got, want_jax) <= 1


def test_entry_matches_the_oracle(flagship):
    frame, got, _, oracle = flagship
    assert _maxdiff(got, oracle) <= 1


def test_entry_with_its_own_banks_matches_jax_banks(flagship):
    frame, got, _, _ = flagship
    fn, (_, banks) = graft_entry.entry(device="cpu")
    assert _maxdiff(fn(torch.from_numpy(frame), banks).numpy(), got) <= 1


def test_dryrun_multichip_on_two_cpu_entries(monkeypatch):
    """Every step on ["cpu", "cpu"] and S = 2 gloo ranks, each within 1 LSB
    of the one-device call; one timeout for the spawn."""
    monkeypatch.setattr(graft_entry, "SPAWN_TIMEOUT_S", SPAWN_TIMEOUT_S)
    diffs = graft_entry.dryrun_multichip(2, device="cpu")
    steps = {"dp", "planes", "serial planes", "serial", "staged 32x128", "staged 96x120"}
    assert steps <= set(diffs) and sum(k.startswith("sp ") for k in diffs) == 7
    assert all(d <= 1 for d in diffs.values()), diffs


def test_without_a_card_both_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(ValueError, match="n must be"):
        graft_entry.dryrun_multichip(0, device="cpu")


def test_dryrun_fails_a_step_past_its_tolerance(monkeypatch):
    """The steps' checks raise (also under python -O): with no difference
    allowed at all, the first step that differs fails with its name."""
    monkeypatch.setattr(graft_entry, "TOL_LSB", -1)
    with pytest.raises(AssertionError, match="dp: 0 LSB from the one-device call"):
        graft_entry.dryrun_multichip(1, device="cpu")
