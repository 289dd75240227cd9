"""frames_per_s: every frame completed in the window over the whole
window, host clock (a window of seconds, read to well under 0.1 %)."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
