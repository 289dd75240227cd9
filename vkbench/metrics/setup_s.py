"""setup_s: host clock from the benchmark's first line to the window's first
call: Python and torch imports, the card, the kernels' build (first run in a
checkout) or load, the banks, the seeded inputs and the warm-up calls."""


def read(run):
    return run.setup_s
