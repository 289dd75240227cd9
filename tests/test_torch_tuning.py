"""The port's per-card tuning table (vkresample_tpu_torch/core/tuning.py) on
the CPU: the default row against the JAX package's, name matching, the
DENSE_MAX seam, a card's row on the route functions (a lower cap moves
only the plan families the dense-cap sweep times), the pipeline cache keyed on the
cap, the dense-cap sweep's decision rule on synthetic readings, and the
new modules importing neither jax nor the JAX package."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vkresample_tpu.core.tuning import DeviceTuning as JDeviceTuning
from vkresample_tpu_torch import Engine, Precision, UpscalePlan
from vkresample_tpu_torch.core import plan as plan_mod
from vkresample_tpu_torch.core import tuning
from vkresample_tpu_torch.fft import mxu_pipeline
from vkresample_tpu_torch.pipeline import upscale as tpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOW = 64  # a card's row below the small plans' axes


@pytest.fixture
def table(monkeypatch):
    """A table of the test's own, the name cache cleared around it."""
    rows = {}
    monkeypatch.setattr(tuning, "_TABLE", rows)
    tuning.row_for_name.cache_clear()
    yield rows
    tuning.row_for_name.cache_clear()


@pytest.fixture
def low_row(monkeypatch):
    """Every device takes a row with dense_max = LOW, as a card with a row
    would; the pipeline cache cleared around it."""
    monkeypatch.setattr(tuning, "_row", lambda device: tuning.DeviceTuning(dense_max=LOW))
    tpipe._build.cache_clear()
    yield
    tpipe._build.cache_clear()


def test_cpu_takes_the_default_row_equal_to_jax():
    assert tuning.current("cpu") == tuning.DeviceTuning()
    assert tuning.current(torch.device("cpu")).dense_max == JDeviceTuning().dense_max == 8192
    plan = UpscalePlan(h=32, w=128, upscale=2.0)
    assert tuning.plan_for(plan, "cpu") is plan  # no row: the plan as it is


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", 4096), ("NVIDIA H100 PCIe", 4096),
    ("NVIDIA A100-SXM4-80GB", None), ("", None)])
def test_rows_match_a_substring_of_the_name(table, name, want):
    table["H100"] = tuning.DeviceTuning(dense_max=4096)
    row = tuning.row_for_name(name)
    assert (row.dense_max if row else None) == want


def test_the_first_matching_row_wins_and_names_are_cached(table):
    table["H100"] = tuning.DeviceTuning(dense_max=2048)
    table["H1"] = tuning.DeviceTuning(dense_max=1024)
    assert tuning.row_for_name("NVIDIA H100 80GB HBM3").dense_max == 2048
    assert tuning.row_for_name("NVIDIA H10").dense_max == 1024
    assert tuning.row_for_name.cache_info().hits == 0
    tuning.row_for_name("NVIDIA H10")
    assert tuning.row_for_name.cache_info().hits == 1


def test_dense_max_seam_lowers_the_default(monkeypatch):
    monkeypatch.setattr(plan_mod, "DENSE_MAX", LOW)
    assert tuning.current("cpu").dense_max == LOW
    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.HALF)
    assert plan.above_dense_cap and mxu_pipeline.bank_set(plan) == "staged"
    monkeypatch.setattr(plan_mod, "DENSE_MAX", 8192)
    assert tuning.current("cpu").dense_max == 8192
    assert mxu_pipeline.bank_set(plan) == "rows"


# (h, w, u, r2c, the tag with a row at LOW, planes_format there); the same
# plans take rows / chain below the default cap.  The families the sweep
# times (mxu_pipeline.card_cap_applies)
STAGED = [
    (32, 128, 2.0, True, "staged", "quad"),   # staged quad, 128-aligned
    (32, 96, 2.0, True, "staged", "quad"),    # staged quad, rows below the cap
    (32, 40, 3.0, True, "grid", "grid"),      # r2c grid u=3
    (32, 48, 1.5, True, "grid", "grid"),      # r2c grid 3/2
]


@pytest.mark.parametrize("h,w,u,r2c,tag,fmt", STAGED)
def test_a_low_row_moves_staged_plans(low_row, h, w, u, r2c, tag, fmt):
    plan = UpscalePlan(h=h, w=w, upscale=u, r2c=r2c, precision=Precision.HALF)
    tuned = tuning.plan_for(plan, "cpu")
    assert tuned.dense_max == LOW and not tuned.above_dense_cap
    assert mxu_pipeline.card_cap_applies(tuned) and mxu_pipeline.above_cap(tuned)
    assert mxu_pipeline.bank_set(tuned) == tag and tpipe.planes_format(tuned) == fmt
    assert mxu_pipeline.bank_set(plan) != tag  # the plan without the row: the dense tier


# plans outside the swept families keep their routes under the low row:
# those no staged bank set takes, and those a staged set takes that the
# sweep did not time (c2c p > 4, r2c u = 4, the fraction 5/2)
KEPT = [
    dict(h=32, w=40, upscale=5.0, r2c=False, precision=Precision.HALF),  # c2c grid p = 5
    dict(h=32, w=40, upscale=4.0, precision=Precision.HALF),             # r2c grid u = 4
    dict(h=32, w=48, upscale=2.5, precision=Precision.HALF),             # r2c grid 5/2
    dict(h=22, w=64, upscale=2.0),               # 22 rows: no Cooley-Tukey split
    dict(h=64, w=64, upscale=1.3333334),         # a fraction with no grid form
    dict(h=37, w=50, upscale=1.0),               # u = 1
    dict(h=64, w=128, upscale=2.0, precision=Precision.DOUBLE),  # -p 1
    dict(h=22, w=64, upscale=2.0, engine=Engine.MXU),
    dict(h=64, w=64, upscale=1.3333334, engine=Engine.MXU),
]


@pytest.mark.parametrize("kw", KEPT, ids=[str(sorted(k.items())) for k in KEPT])
def test_a_low_row_keeps_other_plans_and_raises_nothing(low_row, kw):
    plan = UpscalePlan(**kw)
    tuned = tuning.plan_for(plan, "cpu")
    assert tuned.dense_max == LOW and not mxu_pipeline.card_cap_applies(tuned)
    assert not mxu_pipeline.above_cap(tuned)
    assert mxu_pipeline.bank_set(tuned) == mxu_pipeline.bank_set(plan)
    assert tpipe.route_engine(tuned) is tpipe.route_engine(plan)
    assert tpipe.planes_format(tuned) == tpipe.planes_format(plan)
    assert tpipe._parity_route(tuned) == tpipe._parity_route(plan)


@pytest.mark.parametrize("row,tier,tag", [
    (tuning.DeviceTuning(dense_max=4608, dense_tier="fft"), "fft", "fft"),  # the H100's
    (tuning.DeviceTuning(dense_max=4608), "gemm", "rows"),
    (None, "gemm", "rows"),  # no row: the CPU, a card not in the table
])
def test_plan_for_fills_the_tier(monkeypatch, row, tier, tag):
    """plan_for fills the row's tier beside its cap; a card with no row
    keeps the plan, and the dense GEMM tier with it."""
    monkeypatch.setattr(tuning, "_row", lambda device: row)
    plan = UpscalePlan(h=64, w=128, upscale=2.0, precision=Precision.HALF)
    tuned = tuning.plan_for(plan, "cpu")
    assert tuned.dense_tier == tier
    assert tuned.dense_max == (row.dense_max if row else None)
    assert mxu_pipeline.bank_set(tuned) == tag
    assert tpipe.planes_format(tuned) == "quad"


def test_a_caller_set_cap_is_kept(low_row):
    plan = UpscalePlan(h=32, w=128, upscale=2.0, dense_max=4096)
    assert tuning.plan_for(plan, "cpu") is plan
    assert mxu_pipeline.bank_set(plan) == "rows"


def test_the_pipeline_cache_keys_on_the_cap(monkeypatch):
    """The same plan built for a device without a row and for one with a
    row gives two pipelines (the staged and the dense tier), both within
    1 LSB of the other on the same frame."""
    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.HALF)
    tpipe._build.cache_clear()
    try:
        fn_default = tpipe.build_upscale(plan, "cpu", planes_out=True)
        monkeypatch.setattr(tuning, "_row", lambda device: tuning.DeviceTuning(dense_max=LOW))
        fn_row = tpipe.build_upscale(plan, "cpu", planes_out=True)
        assert fn_row is not fn_default and tpipe._build.cache_info().misses == 2
        assert tpipe.build_upscale(plan, "cpu", planes_out=True) is fn_row
        img = np.random.default_rng(19).integers(0, 256, (32, 128, 3), np.uint8)
        a, b = fn_default(img), fn_row(img)
        assert len(a) == len(b) == 4
        assert max(int((p.int() - q.int()).abs().max()) for p, q in zip(a, b)) <= 1
    finally:
        tpipe._build.cache_clear()


def test_batched_dp_shares_take_each_devices_row(monkeypatch):
    """A "dp" list builds each share with its own device's cap: here the
    first entry has a row, the second none."""
    from vkresample_tpu_torch.pipeline.batched import build_batched_upscale

    built = []
    real = tpipe._build.__wrapped__

    def spy(plan, device, planes_out, planar_out):
        built.append(plan.dense_max)
        return real(plan, device, planes_out, planar_out)

    rows = iter([tuning.DeviceTuning(dense_max=LOW), None, None])
    monkeypatch.setattr(tuning, "_row", lambda device: next(rows))
    from vkresample_tpu_torch.pipeline import batched
    monkeypatch.setattr(batched, "_build", spy)
    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.HALF)
    frames = np.random.default_rng(1).integers(0, 256, (2, 32, 128, 3), np.uint8)
    out = build_batched_upscale(plan, ["cpu", "cpu"])(frames)
    assert built == [LOW, None] and [o.shape for o in out] == [(1, 64, 256, 3)] * 2
    one = tpipe.build_upscale(plan, "cpu")(frames)  # no row left: the dense tier
    assert int((torch.cat(out).int() - one.int()).abs().max()) <= 1


def test_cli_takes_the_cards_row(monkeypatch, tmp_path, capsys):
    """The single-image CLI builds the plan with its card's cap: a 96-wide
    u=2 frame runs the staged quad (four parity planes) under a low row
    instead of the rows route, within 1 LSB of the oracle."""
    from vkresample_tpu_torch import cli
    from vkresample_tpu_torch.io import png

    built = []
    real = tpipe._build.__wrapped__
    monkeypatch.setattr(tpipe, "_build", lambda plan, *a: built.append(plan) or real(plan, *a))
    monkeypatch.setattr(tuning, "_row", lambda device: tuning.DeviceTuning(dense_max=LOW))
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    png.write_png(src, np.random.default_rng(7).integers(0, 256, (32, 96, 3), np.uint8))
    assert cli.main(["-i", src, "-o", dst, "-u", "2", "-p", "2", "-validate"], device="cpu") == 0
    assert "(tol 1) OK" in capsys.readouterr().out
    assert [p.dense_max for p in built] == [LOW]
    assert mxu_pipeline.bank_set(built[0]) == "staged"


def test_folder_cli_weaves_when_cards_differ(monkeypatch, tmp_path, capsys):
    """Two "dp" devices whose rows give the plan different plane layouts
    (staged quad planes on one, rows planes on the other): the folder CLI
    asks both for woven frames, equal within 1 LSB to a one-device run."""
    import itertools

    from vkresample_tpu_torch import cli
    from vkresample_tpu_torch.io import png
    from vkresample_tpu_torch.io.folder import frame_paths

    n = 4
    inp, one, two = (tmp_path / d for d in ("inp", "one", "two"))
    for d in (inp, one, two):
        d.mkdir()
    frames = np.random.default_rng(8).integers(0, 256, (n, 32, 96, 3), np.uint8)
    for path, f in zip(frame_paths(str(inp), n), frames):
        png.write_png(path, f)
    base = ["-ifolder", str(inp), "-numfiles", str(n), "-u", "2", "-p", "2"]
    assert cli.main(base + ["-ofolder", str(one)], device="cpu") == 0
    rows = itertools.cycle([tuning.DeviceTuning(dense_max=LOW), None])
    monkeypatch.setattr(tuning, "_row", lambda device: next(rows))
    tpipe._build.cache_clear()
    try:
        assert cli.main(base + ["-ofolder", str(two)], device=["cpu", "cpu"]) == 0
    finally:
        tpipe._build.cache_clear()
    assert "(2 device(s))" in capsys.readouterr().out
    for a, b in zip(frame_paths(str(one), n), frame_paths(str(two), n)):
        assert int(np.abs(png.read_png(a).astype(int) - png.read_png(b)).max()) <= 1


# ---------------------------------------------------------------------------
# the sweep's decision rule (scripts/torch_dense_cap_sweep.py::decide)
# ---------------------------------------------------------------------------


def _sweep():
    spec = importlib.util.spec_from_file_location(
        "torch_dense_cap_sweep", os.path.join(ROOT, "scripts", "torch_dense_cap_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reading(family, axis, dense, staged):
    return dict(family=family, axis=axis, dense=list(dense), staged=list(staged))


FAST, SLOW = (1.0, 1.01, 0.99), (2.0, 2.02, 1.98)
CLOSE = (1.5, 1.6, 1.4)


@pytest.mark.parametrize("readings,want", [
    # staged faster past 4096 in every family and mode: c = 4096, a row
    ([_reading("a", 3840, FAST, SLOW), _reading("a", 4096, FAST, SLOW),
      _reading("a", 6144, SLOW, FAST), _reading("b", 7680, SLOW, FAST),
      _reading("a", 8192, SLOW, FAST), _reading("a", 9216, SLOW, FAST)], (4096, 4096)),
    # one reading past 4096 is a tie: the row moves up to it
    ([_reading("a", 4096, FAST, SLOW), _reading("a", 6144, SLOW, FAST),
      _reading("b", 7680, SLOW, (1.9, 2.1, 1.0)), _reading("a", 8192, SLOW, FAST)], (7680, 7680)),
    # staged faster everywhere: the smallest swept axis
    ([_reading("a", 2880, SLOW, FAST), _reading("a", 3840, SLOW, FAST)], (2880, 2880)),
    # staged faster only past 8192: no row
    ([_reading("a", 4096, FAST, SLOW), _reading("a", 8192, FAST, CLOSE),
      _reading("a", 9216, SLOW, FAST)], (8192, None)),
    # dense faster at 9216 but only one family swept there: no row
    ([_reading("a", 8192, FAST, SLOW), _reading("a", 9216, FAST, SLOW),
      _reading("b", 7680, FAST, SLOW)], (9216, None)),
    # dense faster past 8192 in every family: a row above the default
    ([_reading("a", 9216, FAST, SLOW), _reading("b", 9216, FAST, SLOW)], (9216, 9216)),
])
def test_sweep_rule(readings, want):
    assert _sweep().decide(readings) == want


def test_sweep_faster_needs_the_medians_apart_by_both_spreads():
    s = _sweep()
    assert s.staged_faster([2.0, 2.1, 1.9], [1.0, 1.05, 0.95])
    assert not s.staged_faster([2.0, 2.5, 1.5], [1.0, 1.05, 0.95])  # dense spread 1.0
    assert not s.staged_faster([2.0, 2.1, 1.9], [1.0, 2.0, 0.5])    # staged spread 1.5
    assert s.dense_faster([1.0, 1.05, 0.95], [2.0, 2.1, 1.9])
    assert s.median_spread([3.0, 1.0, 2.0]) == (2.0, 2.0)


def test_sweep_variants_pick_the_tiers():
    s = _sweep()
    for family, (h, w), u in s.PLANS:
        plan = UpscalePlan(h=h, w=w, upscale=u, precision=Precision.HALF)
        tags = tuple(mxu_pipeline.bank_set(s.variant_plan(plan, v)) for v in ("dense", "staged"))
        assert tags == s.TAGS[family], (family, h, w, u)
        assert mxu_pipeline.card_cap_applies(plan), (family, h, w, u)
        assert s.variant_plan(plan, "xla").engine is Engine.XLA


def test_new_modules_import_no_jax():
    """core/tuning.py, graft_entry.py and what they import load with jax
    and the JAX package blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['vkresample_tpu'] = None\n"
        "import vkresample_tpu_torch.core.tuning, vkresample_tpu_torch.graft_entry\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'vkresample_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_the_h100_row():
    """The table's one row, from the sweep: the H100 SXM part's name takes
    dense_max 4608 and the cuFFT tier below it; the parts not measured keep
    the default."""
    tuning.row_for_name.cache_clear()
    assert tuning.row_for_name("NVIDIA H100 80GB HBM3") == tuning.DeviceTuning(
        dense_max=4608, dense_tier="fft")
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB"):
        assert tuning.row_for_name(name) is None
