"""The rank function of an sp run: every case on this rank, for
parallel/launch.py::spawn (the tests and chip_smoke.py start it; a child
imports it from here, never from a test module).

    results = spawn(S, sp_frames, (cases, device, iters), backend=...)

Each case is (form, plan, frame): form a key of distributed.BUILDERS, the
whole (h, w, C) uint8 frame, of which each rank takes its own rows
(shard_rows).  Each rank returns, per case, a dict:

  block        its output block as a numpy array (gather_blocks joins them
               along distributed.OUTPUT_AXIS[form])
  launches     {"K3": n, "K3h": n, "K6": n}: the CAS kernels' launch
               counters (K3h: K3's column-halo entry), set to 0 just
               before the first call and read just after it
  peak_bytes   the device's peak allocation over that call (CUDA only)
  ms           with iters > 0 on a card: ms per frame over iters calls
               after the first (CUDA events)
  collective_share   the share of iters calls' host time spent in the
               collectives (distributed.collective_seconds: a second loop,
               synchronized around each collective)
"""
from __future__ import annotations

import time

import torch

from ..ops.cas_cuda import cas_quantize, cas_quantize_blocked, cas_quantize_cols_halo
from .distributed import BUILDERS, collective_seconds, shard_rows


def sp_frames(rank: int, group, cases, device=None, iters: int = 0):
    import torch.distributed as dist

    S = dist.get_world_size(group)
    out = []
    for form, plan, frame in cases:
        fn = BUILDERS[form](plan, group, device)
        block = torch.from_numpy(shard_rows(frame, rank, S).copy())
        cuda = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cas_quantize.launches = cas_quantize_blocked.launches = 0
        cas_quantize_cols_halo.launches = 0
        res = fn(block)
        if cuda:
            torch.cuda.synchronize()
        rec = dict(launches={"K3": cas_quantize.launches, "K3h": cas_quantize_cols_halo.launches,
                             "K6": cas_quantize_blocked.launches},
                   block=res.cpu().numpy(),
                   peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
        if iters and cuda:
            x = block.to(res.device)
            dist.barrier(group)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(x)
            end.record()
            end.synchronize()
            rec["ms"] = start.elapsed_time(end) / iters
            dist.barrier(group)
            with collective_seconds() as clock:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                torch.cuda.synchronize()
                rec["collective_share"] = clock[0] / (time.perf_counter() - t0)
        del res
        out.append(rec)
    return out


def probe_input(rank: int, shards: int) -> torch.Tensor:
    """Rank `rank`'s int32 input of collectives_probe, (S, 2S, 3S), distinct
    on every rank and element."""
    S = shards
    return torch.arange(S * 2 * S * 3 * S, dtype=torch.int32).reshape(S, 2 * S, 3 * S) \
        + 1000 * rank


def collectives_probe(rank: int, group):
    """The collectives of parallel/distributed.py on probe_input, for a
    test to hold against numpy models of jax.lax's semantics: all_to_all
    over several (split, concat) axis pairs in int16, float32 and
    complex64, all_gather on the rows, psum, and the row and column
    halos."""
    import torch.distributed as dist

    from . import distributed as sp

    x = probe_input(rank, dist.get_world_size(group))
    a2a = {(split, concat, name): sp._all_to_all(x.to(getattr(torch, name)), split, concat, group)
           for split, concat in ((2, 1), (1, 2), (0, 2), (2, 2), (-1, -3))
           for name in ("int16", "float32", "complex64")}
    return {"all_to_all": a2a, "all_gather": sp._all_gather(x, -2, group),
            "psum": sp._psum(x, group), "halo_rows": sp._halo_rows(x, group),
            "halo_cols": sp._halo_cols(x, group)}
