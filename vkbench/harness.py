"""One run of one cell: set-up, the measured window, the check, the
metrics.  Everything a cell needs is found by its names in BENCHMARK.json
(see the package docstring); nothing here names a configuration, a traffic
mix or a metric.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from . import check, inputs, loadgen, reference, sut
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "vkresample_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is jax's, jaxlib's, flax's
    or the JAX package's, compared whole: vkresample_tpu_torch is none of
    them."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module from its file: metric names hold dots, so no import path
    names them."""
    name = "vkbench_file_" + os.path.relpath(path).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its files resolved by name."""

    def __init__(self, root: str, name: str):
        spec = load_spec(root)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = _load_json(os.path.join(root, conf["file"]))
        base = os.path.join(root, "vkbench")
        self.traffic = _load_json(os.path.join(base, "traffic", self.entry["traffic"] + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
        self.metrics_dir = os.path.join(base, "metrics")

    def metric_path(self, metric: dict) -> str:
        return os.path.join(self.metrics_dir, metric["name"] + ".py")


class Run:
    """What a metric's reader reads: the cell's config and traffic, the
    window (frames, calls, window_s, latencies_ms), peak_window_bytes,
    setup_s, the card's name and power limit, and with --trace 1 the
    trace (trace.Trace)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def sample_calls(seed: int, seconds: float, call_s: float, k: int) -> set:
    """k call indices of the window, drawn from the seed among the calls
    that half the window holds at the warm-up's pace (a traced window runs
    up to a third slower, and every drawn call has to come)."""
    n = max(1, int(0.5 * seconds / max(call_s, 1e-6)))
    rng = np.random.default_rng([int(seed), 7])
    return set(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def make_pool(cell: Cell, seed: int, device) -> list:
    """The traffic's pool of seeded inputs, on the device or in pinned host
    memory as the traffic says."""
    c, t = cell.config, cell.traffic
    pin = device.type == "cuda" and t["input"] == "pinned_host"
    pool = []
    for j in range(int(t["pool_calls"])):
        x = inputs.make_frames(seed, j, int(t["frames_per_call"]), c["h"], c["w"],
                               c["channels"], device)
        if t["input"] == "pinned_host":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            host.copy_(x)
            x = host
        pool.append(x)
    return pool


class Keeper:
    """Host copies of the sampled calls' outputs, made on the stream right
    after each call into buffers allocated in set-up."""

    def __init__(self, like, k: int, device):
        pin = device.type == "cuda"
        self.bufs = [[torch.empty(p.shape, dtype=p.dtype, pin_memory=pin) for p in like]
                     for _ in range(k)]
        self.kept = []  # (call index, buffer slot)

    def __call__(self, i: int, planes) -> None:
        slot = len(self.kept)
        for b, p in zip(self.bufs[slot], planes):
            b.copy_(p, non_blocking=True)
        self.kept.append((i, slot))


def check_kept(cell: Cell, keeper: Keeper, fmt, seed: int, device, limits: dict):
    """(numbers, frames that failed, frames checked): the kept outputs
    against the reference on the same frames, made again from the seed."""
    tally, failed = check.Tally(), 0
    t, c = cell.traffic, cell.config
    for i, slot in keeper.kept:
        j = i % int(t["pool_calls"])
        frames = inputs.make_frames(seed, j, int(t["frames_per_call"]), c["h"], c["w"],
                                    c["channels"], device)
        want = reference.upscale_frames(frames, c)
        got = check.weave(tuple(b.to(device) for b in keeper.bufs[slot]), fmt)
        for f in range(got.shape[0]):
            failed += tally.add(got[f:f + 1], want[f:f + 1]) > limits.get("max_lsb", 0)
        del want, got, frames
    return tally.numbers(), failed, tally.frames


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, build: Callable = sut.build, log=print) -> dict:
    """One run of the cell `name`; returns the result line's object.
    `build` makes the system under test (sut.build; the tests plant faults
    through it); `log` takes the lines for standard error."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = Cell(root, name)
    readers = [(m, load_module(cell.metric_path(m)))
               for m in (cell.per_layer if traced else cell.end_to_end)]
    limits = cell.config["check"]

    stages = [("imports", time.perf_counter())]
    fn, fmt = build(cell.config, device)
    stages.append(("system built (banks uploaded)", time.perf_counter()))
    pool = make_pool(cell, seed, device)
    stages.append(("inputs made", time.perf_counter()))
    call_s, like = loadgen.warm_up(fn, pool, cell.traffic, device)
    stages.append(("warm-up (the kernels' build or load)", time.perf_counter()))
    keeper = Keeper(like, int(cell.traffic["check_calls"]), device)
    del like
    stages.append(("check buffers pinned", time.perf_counter()))
    sample = sample_calls(seed, seconds, call_s, int(cell.traffic["check_calls"]))
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    power = None
    if traced and cuda:
        from .peaks import power_limit

        power = power_limit()
    build_info = sut.last_build() if cuda else {}
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    prof = contextlib.nullcontext()
    label = lambda _: contextlib.nullcontext()  # noqa: E731
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        label = record_function
    gc.collect()
    gc.disable()  # no collector pause inside the window, as timeit does
    try:
        with prof as p:
            win = loadgen.run_window(fn, pool, cell.traffic, seconds, device, sample, keeper, label)
    finally:
        gc.enable()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = win["t0"] - t_start
    trace = Trace(p.profiler.kineto_results.events()) if traced else None

    del fn, pool, p, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not keeper.kept:
        log("check: no call of the window was kept for the check")
    t_check = time.perf_counter()
    numbers, failed, frames_checked = check_kept(cell, keeper, fmt, seed, device, limits)
    t_check = time.perf_counter() - t_check
    correct = bool(keeper.kept) and check.judge(numbers, limits)

    run = Run(config=cell.config, traffic=cell.traffic, frames=win["frames"],
              calls=win["calls"], window_s=win["window_s"], latencies_ms=win["latencies_ms"],
              peak_window_bytes=window_peak if cuda else None, setup_s=setup_s, card=card,
              power_limit=power, trace=trace)
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": 1,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": correct, "attempted": win["frames"], "failed": int(failed),
              "metrics": metrics, "device": dev}
    if traced:
        if trace is not None and cuda:
            dev["busy_s"] = trace.busy_s()
            dev["window_s"] = trace.window_s
            result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
        if power is not None:
            dev["power_limit"] = power
    if build_info:
        result["build"] = build_info
    log(f"cell {name}: seed {seed}, {win['calls']} calls, {win['frames']} frames in "
        f"{win['window_s']:.3f} s; set-up {setup_s:.3f} s (kernels compiled in this process: "
        f"{build_info.get('compiled')}, {build_info.get('seconds', 0.0):.1f} s); {card}"
        + (f"; {power}" if power else ""))
    log("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                                in zip([("start", t_start)] + stages, stages)))
    lat = np.asarray(win["latencies_ms"])
    if lat.size:
        log("call spans, ms: " + ", ".join(
            f"p{q} {np.percentile(lat, q):.4f}" for q in (50, 95, 99)) + f", max {lat.max():.4f}")
    log(f"check: {frames_checked} frames of {len(keeper.kept)} calls against the reference "
        f"in {t_check:.3f} s")
    result["check"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result


def check_lines(result: dict) -> list:
    """The numbers compared, each beside its limit, for standard error."""
    return [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in result["check"].items()]
