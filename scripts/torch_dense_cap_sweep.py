"""Where the dense GEMM tier and the staged circulant tier cross on the card:
the sweep that sets a card's row in vkresample_tpu_torch/core/tuning.py.

    python3 scripts/torch_dense_cap_sweep.py [--passes 5] [--out FILE.json]

Every plan below runs on both tiers in one process on the card, through
build_upscale as the CLI calls it (the parity planes where the route has
them, else the planar image), 3 channels, a seeded uint8 frame in device
memory.  The tier is chosen through the plan's own cap
(UpscalePlan.dense_max): the plan's largest axis for the dense tier (the
cap raised past DENSE_MAX for the 9216 plan), one less for the staged
tier.  Beside them, printed only, the reference tier (-engine xla):

  family          plans (input -> output)              dense         staged
  u2 w%128=0      1920x1080 -> 3840x2160 ...           quad + K1     staged quad + K1
                  4608x2304 -> 9216x4608
  u2 w%128!=0     1440x1080, 2400x1350, 2880x1620      rows + K2     staged quad + K1
  u3              1280x720, 1536x864, 2560x1440        rows u + K5   r2c grid + K4
  1.5x            2560x1440, 3072x1728, 5120x2880      chain + K3    r2c grid 3/2 + K4

These are the families a card's cap applies to
(fft/mxu_pipeline.py::card_cap_applies); every plan here is checked to be
one of them, and the other plans keep the default cap.

each at -p 2 and -p 0.  Before any timing, each plan's two tiers are held
against each other (<= 1 LSB, the share of identical pixels printed) and
both against the fp64 oracle (<= 1 LSB; the oracles are computed in 4
worker processes while the card builds and checks).  Then, with the
workers stopped, the times: ms/frame with CUDA events
(pipeline/timing.py::time_amortized), -n 20 after a warm-up, -n 5 where an
output axis is >= 7680, every variant of every plan in turn (dense,
staged, xla at -p 2, then at -p 0, plan after plan) in each of --passes
passes (default 5); the median and the spread (max - min) over the
passes.

The rule (decide): the card's dense_max is the smallest swept axis c such
that every swept plan whose largest axis passes c runs faster on its
staged tier, in every family and both modes, "faster" meaning the medians
differ by more than both spreads.  c >= DENSE_MAX gives no row (a row
above DENSE_MAX would need the dense tier to win past it in every family,
and only one family is swept there).

It prints the card's name and power limit, a line per reading, the table
in markdown and the rule's answer, and with --out FILE writes every
reading to FILE as JSON.  Needs a CUDA device; exits 1 without one, and 1
when an output is more than 1 LSB from another.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CAP = 8192  # core/plan.py::DENSE_MAX
TOL_LSB = 1
# (family, (h, w) of the input, upscale)
PLANS = [
    ("u2 w%128=0", (1080, 1920), 2.0),
    ("u2 w%128=0", (1024, 2048), 2.0),
    ("u2 w%128=0", (1152, 2304), 2.0),
    ("u2 w%128=0", (1536, 3072), 2.0),
    ("u2 w%128=0", (2160, 3840), 2.0),
    ("u2 w%128=0", (2048, 4096), 2.0),
    ("u2 w%128=0", (2304, 4608), 2.0),
    ("u2 w%128!=0", (1080, 1440), 2.0),
    ("u2 w%128!=0", (1350, 2400), 2.0),
    ("u2 w%128!=0", (1620, 2880), 2.0),
    ("u3", (720, 1280), 3.0),
    ("u3", (864, 1536), 3.0),
    ("u3", (1440, 2560), 3.0),
    ("1.5x", (1440, 2560), 1.5),
    ("1.5x", (1728, 3072), 1.5),
    ("1.5x", (2880, 5120), 1.5),
]
# family -> the bank-set tags (fft/mxu_pipeline.py::bank_set) of its two tiers
TAGS = {"u2 w%128=0": ("rows", "staged"), "u2 w%128!=0": ("rows", "staged"),
        "u3": ("rows", "grid"), "1.5x": ("chain", "grid")}
MODES = ("HALF", "SINGLE")  # -p 2, -p 0
VARIANTS = ("dense", "staged", "xla")


def largest_axis(plan) -> int:
    return max(plan.h, plan.w, plan.H, plan.W)


def variant_plan(plan, variant: str):
    """The plan on one tier: its own cap at its largest axis (dense) or one
    below it (staged); the reference tier for "xla"."""
    from vkresample_tpu_torch.core.config import Engine

    n = largest_axis(plan)
    if variant == "xla":
        return dataclasses.replace(plan, engine=Engine.XLA)
    return dataclasses.replace(plan, dense_max=n if variant == "dense" else n - 1)


def iters_for(plan) -> int:
    return 5 if max(plan.H, plan.W) >= 7680 else 20


def median_spread(times):
    return statistics.median(times), max(times) - min(times)


def staged_faster(dense_ms, staged_ms) -> bool:
    """The staged tier is faster: the medians differ by more than both
    spreads."""
    (md, sd), (ms, ss) = median_spread(dense_ms), median_spread(staged_ms)
    return md - ms > max(sd, ss)


def dense_faster(dense_ms, staged_ms) -> bool:
    (md, sd), (ms, ss) = median_spread(dense_ms), median_spread(staged_ms)
    return ms - md > max(sd, ss)


def decide(readings, default: int = DEFAULT_CAP):
    """(c, row): c the smallest swept axis such that every reading whose
    axis passes c has its staged tier faster; row the card's dense_max,
    None when the default stands.  readings: dicts with "family", "axis",
    "dense" and "staged" (the passes' ms of one plan in one mode)."""
    axes = sorted({r["axis"] for r in readings})
    c = next(a for a in axes
             if all(staged_faster(r["dense"], r["staged"]) for r in readings if r["axis"] > a))
    if c < default:
        return c, c
    if c > default:
        # raising the cap needs the dense tier to win past the default in
        # every family
        families = {r["family"] for r in readings}
        above = [r for r in readings if r["axis"] > default]
        if ({r["family"] for r in above} == families
                and all(dense_faster(r["dense"], r["staged"]) for r in above)):
            return c, c
    return c, None


def markdown(readings, card: str) -> str:
    """The readings as a markdown table: one row per plan and mode."""
    lines = [f"Card: {card}. ms/frame, median over the passes (spread max - min).", "",
             "| family | plan | mode | axis | dense (tag) | staged (tag) | faster | xla |",
             "|---|---|---|---|---|---|---|---|"]
    for r in readings:
        cells = []
        for v in VARIANTS:
            m, s = median_spread(r[v])
            cells.append(f"{m:.4f} ({s:.4f})")
        faster = ("staged" if staged_faster(r["dense"], r["staged"]) else
                  "dense" if dense_faster(r["dense"], r["staged"]) else "neither")
        lines.append(f"| {r['family']} | {r['plan']} | {r['mode']} | {r['axis']} | "
                     f"{cells[0]} ({r['tags'][0]}) | {cells[1]} ({r['tags'][1]}) | {faster} | "
                     f"{cells[2]} |")
    return "\n".join(lines)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--out", help="write the readings to this JSON file")
    args = ap.parse_args(argv)

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the sweep needs one GPU")
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import gpu_line, oracle_job, seeded_image, u8_diff, woven_hwc

    from vkresample_tpu_torch import Precision, UpscalePlan, build_upscale
    from vkresample_tpu_torch.fft import mxu_pipeline
    from vkresample_tpu_torch.pipeline import upscale as pipe
    from vkresample_tpu_torch.pipeline.timing import time_amortized

    card = gpu_line()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    failures, fns, xs, shapes = [], {}, {}, {}
    # build and check every plan while the oracles run in the workers; the
    # timing starts once the workers are done, so no host work runs beside it
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
        oracles = {(h, w, u): pool.submit(oracle_job, h, w, u, True) for _, (h, w), u in PLANS}
        for family, (h, w), u in PLANS:
            base = {m: UpscalePlan(h=h, w=w, upscale=u, precision=Precision[m]) for m in MODES}
            if not all(mxu_pipeline.card_cap_applies(p) for p in base.values()):
                raise RuntimeError(f"{family} {w}x{h}: not a family a card's cap applies to")
            x = xs[h, w, u] = torch.from_numpy(seeded_image(h, w)).to(dev)
            outs = {}
            t0 = time.perf_counter()
            for m in MODES:
                for v in VARIANTS:
                    plan = variant_plan(base[m], v)
                    if v != "xla":
                        tag = mxu_pipeline.bank_set(plan)
                        want = TAGS[family][VARIANTS.index(v)]
                        if tag != want:
                            raise RuntimeError(f"{family} {w}x{h} {m} {v}: bank set {tag}, "
                                               f"expected {want}")
                    fmt = pipe.planes_format(plan)
                    fn = fns[h, w, u, m, v] = build_upscale(plan, dev, planes_out=fmt is not None,
                                                            planar_out=True)
                    outs[m, v] = woven_hwc(fn(x), fmt or "planar", plan)
            torch.cuda.synchronize()
            p = base[MODES[0]]
            label = f"{w}x{h}->{p.W}x{p.H}"
            shapes[h, w, u] = (label, iters_for(p), largest_axis(p))
            print(f"[build] {family} {label}: 6 pipelines built and run once in "
                  f"{time.perf_counter() - t0:.3f} s")
            want = oracles[h, w, u].result()[0]
            for m in MODES:
                d, same = u8_diff([outs[m, "dense"]], [outs[m, "staged"]])
                line = f"[check] {family} {label} {m}: dense vs staged {d} LSB, identical {same:.6f}"
                ok = d <= TOL_LSB
                for v in VARIANTS:
                    dv, _ = u8_diff([outs[m, v]], [want])
                    line += f"; {v} vs fp64 oracle {dv} LSB"
                    ok = ok and dv <= TOL_LSB
                print(line)
                if not ok:
                    failures.append(line)
            del outs, want
    torch.cuda.empty_cache()
    print(f"[build] every plan built and checked in {time.perf_counter() - t_start:.1f} s; "
          "oracle workers stopped")
    times = {key: [] for key in fns}
    for _ in range(args.passes):
        for (h, w, u, m, v), fn in fns.items():
            n = shapes[h, w, u][1]
            times[h, w, u, m, v].append(time_amortized(fn, (xs[h, w, u],), n, dev)[1])
    readings = []
    for family, (h, w), u in PLANS:
        label, n, axis = shapes[h, w, u]
        for m in MODES:
            r = dict(family=family, plan=label, mode=m, axis=axis, iters=n,
                     tags=TAGS[family], **{v: times[h, w, u, m, v] for v in VARIANTS})
            readings.append(r)
            print(f"[time] {family} {label} {m} -n {r['iters']}: " + ", ".join(
                f"{v} {statistics.median(r[v]):.4f} ms ({' '.join(f'{t:.4f}' for t in r[v])})"
                for v in VARIANTS) + f" on {card}")
    c, row = decide(readings)
    print(markdown(readings, card))
    print(f"[rule] smallest swept axis past which the staged tier wins everywhere: {c}; "
          f"row: {'dense_max = %d' % row if row is not None else 'none (default %d)' % DEFAULT_CAP}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "passes": args.passes, "readings": readings, "c": c,
                       "row": row, "failures": failures}, f, indent=1)
    print(f"[done] {len(readings)} readings in {time.perf_counter() - t_start:.1f} s"
          + (f" -> {args.out}" if args.out else ""))
    for line in failures:
        print(f"[FAIL] {line}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
