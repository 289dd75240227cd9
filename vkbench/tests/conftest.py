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
    the cell tiny.pair, whose configuration, traffic and metric were added
    as new files only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "vkbench"), root / "vkbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    (root / "vkbench" / "configs" / "tiny-64x128-u2-p2.json").write_text(json.dumps(TINY_CONFIG))
    (root / "vkbench" / "traffic" / "tiny3.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "vkbench" / "metrics" / "dummy_calls.py").write_text(DUMMY_METRIC)
    spec["configs"].append({"name": TINY_CONFIG["name"], "source": "a test", "reduced": [],
                            "file": "vkbench/configs/tiny-64x128-u2-p2.json", "why": "a test"})
    spec["workloads"].append({"name": TINY_CELL, "config": TINY_CONFIG["name"],
                              "traffic": "tiny3", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"] in ("frames_per_s", "latency_ms_p95"):
            m["workloads"].append(TINY_CELL)
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "test", "moves": "frames_per_s",
                              "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root)
