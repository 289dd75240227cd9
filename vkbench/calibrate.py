"""The readings that the check's limits are set from, at a cell's own size,
in one process on the card:

    python3 vkbench/calibrate.py --workload <name> --first-seed <n> [--seeds 12]
                                 [--control 3] [--seconds 3]

For each of --seeds seeds, a short window at the cell's load (the
generator and the sample of a run), then the check: max_lsb and
mismatch_pct of the port against the plain reference.  For --control
seeds, the control in the port's place: the reference with its pre-CAS
image stored in float8 e4m3 (reference.py::control_store), on the
frames that the sample of a run draws, against the reference.  One JSON
line per reading; the last line gives the largest readings of the port
(the lower reading) and the smallest of the control (the upper one).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from vkbench import check, harness, inputs, loadgen, reference, sut

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.Cell(ROOT, args.workload)
    limits, t, c = cell.config["check"], cell.traffic, cell.config
    k = int(t["check_calls"])
    fn, fmt = sut.build(c, dev)
    lows = []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        t0 = time.perf_counter()
        pool = harness.make_pool(cell, seed, dev)
        call_s, like = loadgen.warm_up(fn, pool, t, dev)
        keeper = harness.Keeper(like, k, dev)
        del like
        sample = harness.sample_calls(seed, args.seconds, call_s, k)
        win = loadgen.run_window(fn, pool, t, args.seconds, dev, sample, keeper)
        del pool
        numbers, failed, frames = harness.check_kept(cell, keeper, fmt, seed, dev, limits)
        lows.append(numbers)
        print(json.dumps({"side": "port", "seed": seed, **numbers, "frames": frames,
                          "failed": failed, "calls": win["calls"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    del fn
    torch.cuda.empty_cache()
    highs = []
    for seed in range(args.first_seed, args.first_seed + args.control):
        tally = check.Tally()
        drawn = harness.sample_calls(seed, 10, 0.01, k)
        entries = sorted({i % int(t["pool_calls"]) for i in drawn})
        for j in entries:
            frames = inputs.make_frames(seed, j, int(t["frames_per_call"]), c["h"], c["w"],
                                        c["channels"], dev)
            tally.add(reference.upscale_frames(frames, c, store=reference.control_store),
                      reference.upscale_frames(frames, c))
        highs.append(tally.numbers())
        print(json.dumps({"side": "control", "seed": seed, **tally.numbers(),
                          "frames": tally.frames}), flush=True)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(dev),
               "lower": {key: max(n[key] for n in lows) for key in limits},
               "upper": {key: min(n[key] for n in highs) for key in limits} if highs else None,
               "limits": limits}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
