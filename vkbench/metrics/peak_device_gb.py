"""peak_device_gb: torch.cuda.max_memory_allocated over the window, reset at
its start, in GB (1e9 bytes): the system's working set plus what the
benchmark holds on the device through the window (a device-resident input
pool, none for pinned-host traffic)."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
