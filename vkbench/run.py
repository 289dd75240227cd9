"""Run one cell of BENCHMARK.json once, on one card.

    python3 vkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(also `python3 -m vkbench.run ...`) from the root of a checkout.  Set-up
(imports, the card, the kernels' build or load, banks, seeded inputs,
warm-up) runs from process start to the first timed call; then the window
lasts --seconds; then the check compares the sampled outputs with the
plain reference.  The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or its
per-layer metrics with --trace 1), device, with --trace 1 breakdown, and
last check: each number compared beside its limit, which also close
standard error.  Exits non-zero, printing no result, without a CUDA card,
with fewer cards than the cell asks for, where the port cannot be
imported, or when jax, jaxlib, flax or the JAX package is loaded once the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds < 1:
        ap.error("--seed takes a whole number >= 0 and --seconds one >= 1")
    return args


def main(argv=None) -> int:
    args = _args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from vkbench import harness

    if not torch.cuda.is_available():
        print("vkbench: no CUDA device; the benchmark measures the port on a card", file=sys.stderr)
        return 2
    cell = harness.Cell(ROOT, args.workload)
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"vkbench: {args.workload} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    try:
        import vkresample_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"vkbench: the port cannot be imported: {e}", file=sys.stderr)
        return 3
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, log=log)
    banned = harness.forbidden_modules(list(sys.modules))
    if banned:
        print(f"vkbench: loaded after the window: {', '.join(banned)}", file=sys.stderr)
        return 4
    for line in harness.check_lines(result):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
