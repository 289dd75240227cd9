"""The harness on the CPU: BENCHMARK.json against its format's rules,
every cell resolved by name, the result line, the roofline's counts, the
trace reading, and what each process loads."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY_CELL

sys.path.insert(0, ROOT)

from vkbench import check, harness, inputs, reference  # noqa: E402
from vkbench.trace import Trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_its_format_rules():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "vkbench/run.py"] and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["vkbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)), "a name is used twice"
    assert all(NAME.match(n) for n in names), names
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("vkbench/")
        assert c["reduced"] == [] and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source",
                                         "layer", "moves"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:  # each cell it names reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in CELLS:
        reported = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.Cell(ROOT, name)
    for path in [cell.metric_path(m) for m in cell.end_to_end + cell.per_layer]:
        assert os.path.exists(path), path
        assert os.path.relpath(path, ROOT).startswith("vkbench" + os.sep)
    assert {"h", "w", "channels", "upscale", "precision", "sharpen", "r2c", "engine",
            "check"} <= set(cell.config)
    assert cell.config["engine"] == "AUTO"  # the port's default route, nothing pinned
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_module(cell.metric_path(metric)).read)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_of_a_cell_added_as_files(tiny_root, traced):
    lines = []
    res = harness.run_cell(tiny_root, TINY_CELL, 2**31 + 11, 1, traced, "cpu", 0.0,
                           log=lines.append)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res) - {"correct", "attempted", "failed", "metrics", "device"} <= {"check"}
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["device"]["platform"] == "cpu"  # never a device number from the CPU
    want = {"dummy_calls"} if traced else {"frames_per_s", "latency_ms_p95", "setup_s"}
    assert set(res["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["check"]) == {"max_lsb", "mismatch_pct"}
    assert json.loads(json.dumps(res)) == res
    assert harness.check_lines(res)[0].startswith("check max_lsb: ")


@pytest.mark.parametrize("name,nbytes,ops", [
    ("flagship-2048x1024-u2-p2", 3 * 2048 * 4096 * 3, 40 * 3 * 2048 * 4096),
    ("uhd-3840x2160-u2-p2", 3 * 4320 * 7680 * 3, 40 * 3 * 4320 * 7680),
])
def test_roofline_counts_the_cas_stages_work(name, nbytes, ops):
    mod = harness.load_module(os.path.join(ROOT, "vkbench", "metrics", "cas_roofline.batch.py"))
    conf = {c["name"]: c for c in SPEC["configs"]}[name]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    assert mod.work(config) == (nbytes, ops)
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12}
    assert mod.least_seconds(config, peaks) == pytest.approx(nbytes / 3.35e12)  # bytes bind
    assert "cas_grid_kernel" in mod.CAS and "cas_rows_kernel" in mod.CAS


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0, ua=False):
        self._v = (name, dev, start, dur, corr, ua)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_reading():
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    ev = [
        _Ev("vkbench.window", cpu, 0, 100_000, ua=True),
        _Ev("vkbench.call", cpu, 1_000, 9_000, ua=True),
        _Ev("aten::mm", cpu, 1_500, 3_000),
        _Ev("cudaLaunchKernel", cpu, 2_000, 500, corr=7),
        _Ev("cudaMemcpyAsync", cpu, 5_000, 500, corr=8),
        _Ev("cudaLaunchKernel", cpu, 50_000, 500, corr=9),  # outside any call span
        _Ev("k0", gpu, 500, 2_500),
        _Ev("void cas_grid_kernel<2, short>(...)", gpu, 10_000, 20_000, corr=7),
        _Ev("Memcpy HtoD (Pinned -> Device)", gpu, 25_000, 10_000, corr=8),
        _Ev("gemm", gpu, 60_000, 10_000, corr=9),
        _Ev("vkbench.call", gpu, 10_000, 25_000, ua=True),
    ]
    t = Trace(ev)
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy_s() == pytest.approx(37.5e-6)  # [0.5, 3], [10, 35] and [60, 70] us
    assert t.ops_in_calls() == 2
    assert t.op_seconds(lambda n: n.startswith("Memcpy HtoD")) == pytest.approx(1e-5)
    assert t.top_ops(1) == [["cas_grid_kernel<2, short>", pytest.approx(2e-5)]]
    assert dict(t.idle_gaps()) == {"host outside any traced span": pytest.approx(55e-6),
                                   "aten::mm": pytest.approx(7e-6),
                                   "gaps under 2 us (launch latency)": pytest.approx(0.5e-6)}
    with pytest.raises(ValueError):
        Trace(ev[1:])


@pytest.mark.parametrize("fmt,n_planes,p_y,p_x", [("quad", 4, 2, 2), ("rows", 2, 2, 1),
                                                  ("grid", 9, 3, 3)])
def test_weave_puts_each_plane_back(fmt, n_planes, p_y, p_x):
    img = torch.randint(0, 256, (2, 3, 6 * p_y, 4 * p_x), dtype=torch.uint8)
    planes = tuple(img[..., i // p_x::p_y, i % p_x::p_x].contiguous() for i in range(n_planes))
    assert torch.equal(check.weave(planes, fmt), img)
    assert check.weave(img, None) is img


def test_inputs_and_sample_come_from_the_seed():
    big = 2**31 + 12345
    a = inputs.make_frames(big, 2, 2, 40, 48, 3, "cpu")
    assert a.shape == (2, 40, 48, 3) and a.dtype == torch.uint8
    assert torch.equal(a, inputs.make_frames(big, 2, 2, 40, 48, 3, "cpu"))
    assert not torch.equal(a, inputs.make_frames(big, 3, 2, 40, 48, 3, "cpu"))
    assert 40 < float(a.float().std()) < 90  # gradients and texture, not flat, not noise
    s = harness.sample_calls(big, 10, 0.01, 16)
    assert s == harness.sample_calls(big, 10, 0.01, 16) and len(s) == 16 and max(s) < 500


@pytest.mark.parametrize("h,w,u,r2c", [(48, 64, 2.0, True), (40, 60, 1.5, True),
                                       (32, 48, 2.0, False), (24, 32, 3.0, True)])
def test_reference_agrees_with_the_ports_numpy_oracle(h, w, u, r2c):
    from vkresample_tpu_torch.core.plan import UpscalePlan
    from vkresample_tpu_torch.oracle.numpy_ref import upscale_oracle

    img = inputs.make_frames(5, 0, 1, h, w, 3, "cpu")
    got = reference.upscale_frames(img, {"upscale": u, "r2c": r2c, "sharpen": 0.2})[0]
    want = upscale_oracle(img[0].numpy(), UpscalePlan(h=h, w=w, upscale=u, r2c=r2c))
    gap, bad, n = check.compare(got, torch.from_numpy(want).permute(2, 0, 1))
    assert gap <= 1 and bad <= n * 1e-3


def _python(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_a_cpu_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import vkbench.run, vkbench.harness as h;"
        "import vkbench.reference;"
        f"h.run_cell({tiny_root!r}, {TINY_CELL!r}, 3, 1, False, 'cpu', 0.0, log=lambda s: None);"
        "print(h.forbidden_modules(sys.modules), 'vkresample_tpu_torch' in sys.modules)")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, importlib.util as u;"
            "s = u.spec_from_file_location('r', 'vkbench/reference.py');"
            "m = u.module_from_spec(s); s.loader.exec_module(m);"
            "print(sorted({k.split('.')[0] for k in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vkresample_tpu', 'vkresample_tpu_torch', 'vkbench'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "vkbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=_no_card_env())
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_in_a_tree_of_the_benchmark_alone_it_exits_nonzero(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "vkbench"), tmp_path / "vkbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "vkbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=_no_card_env())
    assert out.returncode != 0 and "{" not in out.stdout


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["vkresample_tpu_torch", "vkresample_tpu_torch.core", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["vkresample_tpu.core", "jax._src"]) == [
        "jax", "vkresample_tpu"]


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(card, tiny_root):
    res = harness.run_cell(tiny_root, TINY_CELL, 2**31 + 3, 1, True, card, 0.0,
                           log=lambda s: None)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and "dummy_calls" in res["metrics"]
