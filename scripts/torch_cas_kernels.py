"""Time the CAS kernels K1, K2 and K3 alone at their routes' shapes, eagerly
and on the device alone, for the PyTorch port of a given checkout.

    python3 scripts/torch_cas_kernels.py [DIR]

DIR (default: this script's checkout) is the root of the checkout whose
vkresample_tpu_torch is imported and built, so that two versions are
compared by running the script once on each, in turns, in one call on one
card (parent, change, change, parent).  It uses only wrappers both sides
of such a comparison have.  Seeded inputs (torch.rand on the card, numpy
never), int16 Q2.14 and float32, at:

  K1  4 x (3, 1024, 2048)  the quad and c2c grid u=2 routes (2048x1024 -> 4096x2048)
  K2  2 x (3, 1080, 2880)  the rows route (1440x1080 -> 2880x2160)
      2 x (3, 1024, 4096)  the woven flagship upscale() (2048x1024 -> 4096x2048)
  K3  (3, 2160, 3840)      -engine xla and xla c2c (1920x1080 -> 3840x2160)
      (3, 1080, 1920)      the 1.5x chain (1280x720 -> 1920x1080)
      (3, 1800, 3200)      the c2c 2.5x chain (1280x720 -> 3200x1800)
  K4  9 x (3, 720, 1280), u=3: a control, the c2c grid u=3 route, on the
      kernel whose U=2 instance runs K1
  K5  U (3, 720, 3840) + O (3, 1440, 3840), u=3: a control, the kernel K3
      runs at u=1 and K2 at u=2, here at u=3 on as many outputs as K3's
      first shape

For each it prints, with the card's name and power limit and DIR:

  eager   ms per wrapper call, 50 calls after a warm-up, CUDA events
          (chip_smoke.py::cuda_ms): the kernel and its wrapper's host work
  host    ms per wrapper call of the host alone: the host clock over 50
          calls, read before the device is waited for; eager is about the
          larger of host and device
  launch  ms per call of the kernel's C entry point alone (the ctypes call
          with its arguments made beforehand and the outputs allocated
          once), by the host clock as host: what of host is the launch,
          and host - launch the wrapper's Python and output allocations
  device  ms per call of 50 calls replayed from one CUDA graph
          (chip_smoke.py::graph_ms): the kernel alone
  bound   bytes read once and written once over 3.35 TB/s

Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import ctypes
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
    from vkresample_tpu_torch import _build
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

    # kernel, shape label, argument maker, wrapper call, and its C entry
    # point with the number of outputs it writes
    runs = [("K1", "4 x (3, 1024, 2048)", lambda dt: planes((C, 1024, 2048), 4, dt),
             lambda a: cas_cuda.cas_parity4_planes_u2(*a, 0.2), "vkr_cas_quad_u2", 4)]
    runs += [("K2", f"2 x {shape}", lambda dt, shape=shape: planes(shape, 2, dt),
              lambda a: cas_cuda.cas_parity_planes_u2(*a, 0.2), "vkr_cas_parity_u2", 2)
             for shape in ((C, 1080, 2880), (C, 1024, 4096))]
    runs += [("K3", str(shape), lambda dt, shape=shape: planes(shape, 1, dt),
              lambda a: cas_cuda.cas_quantize(a[0], 0.2), "vkr_cas_woven", 1)
             for shape in ((C, 2160, 3840), (C, 1080, 1920), (C, 1800, 3200))]
    runs += [("K4", "9 x (3, 720, 1280) u=3", lambda dt: planes((C, 720, 1280), 9, dt),
              lambda a: cas_cuda.cas_parity_grid_planes(a, 3, 0.2), "vkr_cas_grid", 9)]
    runs += [("K5", "U (3, 720, 3840) + O (3, 1440, 3840) u=3", k5,
              lambda a: cas_cuda.cas_quantize_rows_u(*a, 0.2), "vkr_cas_rows_u", 1)]

    def entry_args(kid, ins, outs):
        """The C entry point's arguments before is_i16, sharpen and the
        stream: pointers (K4: pointer arrays), then the sizes."""
        C_, h, W = ins[0].shape
        if kid == "K4":
            ptrs = ctypes.c_void_p * 9
            return [ptrs(*(t.data_ptr() for t in ins)), ptrs(*(o.data_ptr() for o in outs)),
                    3, C_, h, W]
        sizes = [C_, h, W] + ([3] if kid == "K5" else [])
        return [t.data_ptr() for t in ins + outs] + sizes

    lib = _build.load_kernels()

    def host_ms(fn):
        """ms per call by the host clock over 50 calls, the device not
        waited for."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        return ms

    for kid, label, make, call, entry, n_out in runs:
        for dt in (torch.int16, torch.float32):
            args = make(dt)
            tensors = [t for t in args if isinstance(t, torch.Tensor)]
            n_bytes = sum(t.numel() for t in tensors) * (tensors[0].element_size() + 1)
            eager = cuda_ms(lambda: call(args), 50)
            host = host_ms(lambda: call(args))
            # the same output buffers for every launch, allocated here and
            # held until the launches are done: the wrapper's allocations
            # are left out
            out_shape = tensors[0].shape
            if kid == "K5":
                out_shape = (C, 3 * out_shape[1], out_shape[2])
            outs = [torch.empty(out_shape, dtype=torch.uint8, device=dev) for _ in range(n_out)]
            cargs = entry_args(kid, tensors, outs)
            cargs += [int(dt == torch.int16), 0.2, torch.cuda.current_stream().cuda_stream]
            fn = getattr(lib, entry)
            rc = fn(*cargs)
            if rc != 0:
                raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")
            launch = host_ms(lambda: fn(*cargs))
            device = graph_ms(lambda: call(args), 50)
            print(f"[{kid}] {label} {dt}: eager {eager:.4f} ms, host {host:.4f} ms, launch "
                  f"{launch:.4f} ms, device {device:.4f} ms, bound "
                  f"{n_bytes / 3.35e12 * 1e3:.4f} ms on {card}; {root}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
