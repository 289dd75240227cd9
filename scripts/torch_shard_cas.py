"""Time the sp pencil mode's shard CAS as parallel/distributed.py runs it,
and K6 at the woven-CAS A/B frame, for the PyTorch port of a given
checkout.

    python3 scripts/torch_shard_cas.py [DIR]

DIR (default: this script's checkout) is the root of the checkout whose
vkresample_tpu_torch is imported and built, so that two versions are
compared by running the script once on each, in turns, in one call on one
card (parent, change, change, parent).  It calls only what both sides of
such a comparison have: distributed._cas_rows and _cas_cols, whose halo
exchange (_halo_rows, _halo_cols) is stubbed by seeded halo rows or
columns, so no process group is needed, and ops/cas_cuda.py's
cas_quantize_blocked.  Seeded inputs (torch.rand on the card), at:

  rows  (3, 2048 / S, 4096) float32, S = 1, 2, 4: _cas_rows on the rows
        form's shards of the 2048x1024 -> 4096x2048 flagship
  cols  (3, 2048, 4096 / S) and (3, 2160, 3840 / S), int16 Q2.14 and
        float32, S = 1, 2, 4: _cas_cols on the column forms' blocks (the
        flagship; the grid form's 1280x720 -> 3840x2160)
  K6    (3, 2048, 4096) float32, bh = 64, 128, 256: cas_quantize_blocked,
        the A/B frame's CAS (chip_smoke.py's "cas ab K6" runs)

For each it prints, with the card's name and power limit and DIR: eager
(ms per call, 50 calls after a warm-up, CUDA events), device (50 calls
replayed from one CUDA graph), the bound (inputs and halos read once,
outputs written once, over 3.35 TB/s) and the device kernels and copies of
one call by torch.profiler.  Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 3
SEED = 20261017


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: the shard CAS times need one GPU")
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, gpu_line, graph_ms

    root = os.path.abspath(argv[0]) if argv else HERE
    sys.path.insert(0, root)
    from vkresample_tpu_torch.ops import cas_cuda
    from vkresample_tpu_torch.ops.cas import to_i16_storage
    from vkresample_tpu_torch.parallel import distributed as sp

    card = gpu_line()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}  package "
          f"{os.path.dirname(cas_cuda.__file__)}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, dt):
        v = torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1
        return to_i16_storage(v) if dt == torch.int16 else v

    def device_kernels(fn):
        """'name x count' of the device kernels and copies of one call."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return "; ".join(f"{e.key[:70]} x{e.count}" for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)

    def report(label, fn, n_bytes):
        eager = cuda_ms(fn, 50)
        device = graph_ms(fn, 50)
        print(f"[{label}] eager {eager:.4f} ms, device {device:.4f} ms, bound "
              f"{n_bytes / 3.35e12 * 1e3:.4f} ms; device kernels: {device_kernels(fn)}; "
              f"{card}; {root}")

    for S in (1, 2, 4):
        v = rand((C, 2048 // S, 4096), torch.float32)
        halos = tuple(rand((C, 1, 4096), torch.float32) for _ in range(2))
        sp._halo_rows = lambda x, group, halos=halos: halos
        report(f"rows S={S} {tuple(v.shape)} float32",
               lambda v=v: sp._cas_rows(v, 0.2, None), v.numel() * 5 + 2 * C * 4096 * 4)
    for H, W in ((2048, 4096), (2160, 3840)):
        for S in (1, 2, 4):
            for dt in (torch.int16, torch.float32):
                v = rand((C, H, W // S), dt)
                halos = tuple(rand((C, H, 1), dt) for _ in range(2))
                sp._halo_cols = lambda x, group, halos=halos: halos
                es = v.element_size()
                report(f"cols S={S} {tuple(v.shape)} {dt}", lambda v=v: sp._cas_cols(v, 0.2, None),
                       v.numel() * (es + 1) + 2 * C * H * es)
    v = rand((C, 2048, 4096), torch.float32)
    for bh in (64, 128, 256):
        report(f"K6 bh={bh} {tuple(v.shape)} float32",
               lambda bh=bh: cas_cuda.cas_quantize_blocked(v, 0.2, bh),
               v.numel() * 5 + 2 * C * -(-2048 // bh) * 4096 * 4)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
