"""Fixtures of the benchmark's own tests (python -m pytest vkbench/tests).

Tests marked `cuda` need a card; the `card` fixture decides inside the
test whether there is one and skips with the reason where there is none.
`tiny_root` builds a checkout-like tree in which a dummy configuration, a
dummy traffic mix and a dummy per-layer metric are added as files and
entries alone, as a later change would add them."""
import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_CELL = "tiny.pair"
WOVEN_CELL = "tiny.woven"  # -u 3: the port hands back the finished image, no planes


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: the benchmark's card tests run on the chip")
    return torch.device("cuda", 0)


TINY_CONFIG = {
    "name": "tiny-64x128-u2-p2", "h": 64, "w": 128, "channels": 3, "upscale": 2.0,
    "precision": "HALF", "sharpen": 0.2, "r2c": True, "engine": "AUTO",
    "check": {"max_lsb": 4, "mismatch_pct": 2.0},
}
WOVEN_CONFIG = dict(TINY_CONFIG, name="tiny-64x128-u3-p2", upscale=3.0)
TINY_TRAFFIC = {
    "frames_per_call": 2, "pool_calls": 3, "input": "pinned_host",
    "in_flight": 2, "warmup_calls": 2, "check_calls": 3,
}
DUMMY_METRIC = '''"""dummy_calls: calls in the window (a test's metric)."""


def read(run):
    return float(run.calls)
'''


@pytest.fixture
def tiny_root(tmp_path):
    """A tree holding vkbench/ and a BENCHMARK.json of the real cells plus
    the cells tiny.pair and tiny.woven, whose configurations, traffic and
    metric were added as new files only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "vkbench"), root / "vkbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    (root / "vkbench" / "traffic" / "tiny3.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "vkbench" / "metrics" / "dummy_calls.py").write_text(DUMMY_METRIC)
    cells = [(TINY_CELL, TINY_CONFIG), (WOVEN_CELL, WOVEN_CONFIG)]
    for cell, config in cells:
        file = f"vkbench/configs/{config['name']}.json"
        (root / file).write_text(json.dumps(config))
        spec["configs"].append({"name": config["name"], "source": "a test", "reduced": [],
                                "file": file, "why": "a test"})
        spec["workloads"].append({"name": cell, "config": config["name"],
                                  "traffic": "tiny3", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"] in ("frames_per_s", "latency_ms_p95"):
            m["workloads"] += [cell for cell, _ in cells]
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "test", "moves": "frames_per_s",
                              "workloads": [cell for cell, _ in cells]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root)
