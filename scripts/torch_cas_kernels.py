"""Time the CAS kernels K1 and K3 alone at their routes' shapes, eagerly and
on the device alone, for the PyTorch port of a given checkout.

    python3 scripts/torch_cas_kernels.py [DIR]

DIR (default: this script's checkout) is the root of the checkout whose
vkresample_tpu_torch is imported and built, so that two versions are
compared by running the script once on each, in turns, in one call on one
card (parent, change, change, parent).  It uses only wrappers both sides
of such a comparison have.  Seeded inputs (torch.rand on the card, numpy
never), int16 Q2.14 and float32, at:

  K1  4 x (3, 1024, 2048)  the quad and c2c grid u=2 routes (2048x1024 -> 4096x2048)
  K3  (3, 2160, 3840)      -engine xla and xla c2c (1920x1080 -> 3840x2160)
      (3, 1080, 1920)      the 1.5x chain (1280x720 -> 1920x1080)
      (3, 1800, 3200)      the c2c 2.5x chain (1280x720 -> 3200x1800)
  K5  U (3, 720, 3840) + O (3, 1440, 3840), u=3: a control, the kernel K3
      runs at u=1, here at u=3 on as many outputs as K3's first shape

For each it prints, with the card's name and power limit and DIR:

  eager   ms per wrapper call, 50 calls after a warm-up, CUDA events
          (chip_smoke.py::cuda_ms): the kernel and its wrapper's host work
  host    ms per wrapper call of the host alone: the host clock over 50
          calls, read before the device is waited for; eager is about the
          larger of host and device
  device  ms per call of 50 calls replayed from one CUDA graph
          (chip_smoke.py::graph_ms): the kernel alone
  bound   bytes read once and written once over 3.35 TB/s

Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 3
SEED = 20261016


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernel times need one GPU")
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, gpu_line, graph_ms

    root = os.path.abspath(argv[0]) if argv else HERE
    sys.path.insert(0, root)
    from vkresample_tpu_torch.ops import cas_cuda
    from vkresample_tpu_torch.ops.cas import to_i16_storage

    card = gpu_line()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}  package "
          f"{os.path.dirname(cas_cuda.__file__)}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def planes(shape, n, dt):
        ps = [torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1 for _ in range(n)]
        return [to_i16_storage(p) for p in ps] if dt == torch.int16 else ps

    def k5(dt):
        U = planes((C, 720, 3840), 1, dt)[0]
        return U, planes((C, 1440, 3840), 1, dt)[0], 3

    # (kernel, shape label, argument maker, call)
    runs = [("K1", "4 x (3, 1024, 2048)", lambda dt: planes((C, 1024, 2048), 4, dt),
             lambda a: cas_cuda.cas_parity4_planes_u2(*a, 0.2))]
    runs += [("K3", str(shape), lambda dt, shape=shape: planes(shape, 1, dt),
              lambda a: cas_cuda.cas_quantize(a[0], 0.2))
             for shape in ((C, 2160, 3840), (C, 1080, 1920), (C, 1800, 3200))]
    runs += [("K5", "U (3, 720, 3840) + O (3, 1440, 3840) u=3", k5,
              lambda a: cas_cuda.cas_quantize_rows_u(*a, 0.2))]
    for kid, label, make, call in runs:
        for dt in (torch.int16, torch.float32):
            args = make(dt)
            n_in = sum(t.numel() for t in args if isinstance(t, torch.Tensor))
            n_bytes = n_in * (args[0].element_size() + 1)
            eager = cuda_ms(lambda: call(args), 50)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call(args)
            host = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            device = graph_ms(lambda: call(args), 50)
            print(f"[{kid}] {label} {dt}: eager {eager:.4f} ms, host {host:.4f} ms, device "
                  f"{device:.4f} ms, bound "
                  f"{n_bytes / 3.35e12 * 1e3:.4f} ms on {card}; {root}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
