"""Start the ranks of a torch.distributed group (the counterpart of building
an "sp" Mesh: JAX's shard_map runs every shard from one program, while
torch.distributed runs one process per rank).

spawn(world, fn, args) starts `world` processes with the "spawn" start
method.  They meet through a FileStore in a temporary directory, so no TCP
port is chosen or opened by the launcher.  Each process sets its CUDA
device (rank % device_count, where there is a card), joins the group on
`backend`, runs fn(rank, group, *args) and writes its result to a file
that the parent reads back.  The parent waits at most timeout_s seconds
for all of them: on expiry it kills every child and raises TimeoutError,
and it raises RuntimeError, with each failing rank's traceback, when a
child fails.

fn must be importable by name in a fresh interpreter (a module-level
function of this package): the children import it, never the caller's
test module.  Its result is saved with torch.save, so it should hold CPU
tensors, numpy arrays and plain Python values.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def _child(rank: int, world: int, fn: Callable, args: Sequence, backend: str, tmp: str,
           timeout_s: float) -> None:
    try:
        import torch
        import torch.distributed as dist

        device = None
        if torch.cuda.is_available():
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            # CPU ranks share the cores instead of each taking all of them
            torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=device if backend == "nccl" else None)
        try:
            result = fn(rank, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        part = os.path.join(tmp, f"result{rank}.part")
        torch.save(result, part)
        os.replace(part, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        # the parent reads the traceback; the child still fails with it
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world: int, fn: Callable, args: Sequence = (), backend: str = "gloo",
          timeout_s: float = 120.0) -> List[Any]:
    """Run fn(rank, group, *args) in `world` new processes, one rank each,
    and return their results in rank order.

    backend: "gloo" (CPU tensors, and CUDA tensors staged through host
    memory) or "nccl" (one card per rank).  There is no fallback from one
    to the other.  timeout_s bounds both the rendezvous and the whole run.
    Without a card each rank takes 1/world of the cores for torch's
    intra-op threads."""
    import torch

    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="vkr-spawn-") as tmp:
        procs = [ctx.Process(target=_child, name=f"rank{rank}",
                             args=(rank, world, fn, tuple(args), backend, tmp, timeout_s))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for rank, p in enumerate(procs):
            path = os.path.join(tmp, f"error{rank}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
            elif p.exitcode != 0 and rank not in hung:
                errors.append(f"rank {rank}: exit code {p.exitcode}")
        if hung:
            raise TimeoutError(
                f"{fn.__name__}: ranks {hung} of {world} ({backend}) still running after "
                f"{timeout_s} s; killed" + "".join("\n" + e for e in errors))
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on {world} ranks ({backend}):\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"result{rank}.pt"), map_location="cpu",
                           weights_only=False) for rank in range(world)]
