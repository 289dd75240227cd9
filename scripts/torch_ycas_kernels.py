"""Time the fused y-GEMM + CAS kernels K8 and K9 alone at their shapes, on
the device alone, beside the unfused pair they would replace, for the
PyTorch port of a given checkout.

    python3 scripts/torch_ycas_kernels.py [DIR]

DIR (default: this script's checkout) is the root of the checkout whose
vkresample_tpu_torch is imported and built, so that two versions are
compared by running the script once on each, in turns, in one call on one
card (parent, change, change, parent).  It uses only wrappers both sides
of such a comparison have.  Seeded inputs (torch.rand on the card) with
the frames' own y banks (fft/dense.py::ycas_bank, r = 1), int16 Q2.14 and
float32 U, at:

  U (3, 1080, 2880)  the rows route's frame, 1440x1080 -> 2880x2160
  U (3, 1024, 4096)  the woven flagship, 2048x1024 -> 4096x2048

For each kernel, shape and dtype it prints, with the card's name and power
limit and DIR:

  device   ms per call of 50 calls replayed from one CUDA graph
           (chip_smoke.py::graph_ms): the kernel alone
  eager    ms per wrapper call, 50 calls, CUDA events (chip_smoke.py::cuda_ms)
  diff     max |diff| and the identical share against the plain version
  bound    chip_smoke.py::ycas_bound: the y GEMM as 3 TF32 products per
           multiply-add over 495 TFLOP/s, and (fp32 FMA) as one fp32
           multiply-add over 67 TFLOP/s; its share is bound / device

and, once per shape and dtype, the device time alone of the unfused pair
(the cuBLAS y GEMM in full fp32, O stored as Q2.14 for int16 U, then K2;
K9's pair woven) and of its y GEMM alone.  Needs a CUDA device; exits 1
without one.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 3
SEED = 20261016
SHAPES = ((C, 1080, 2880), (C, 1024, 4096))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernel times need one GPU")
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, gpu_line, graph_ms, u8_diff, ycas_bound

    root = os.path.abspath(argv[0]) if argv else HERE
    sys.path.insert(0, root)
    from vkresample_tpu_torch import UpscalePlan
    from vkresample_tpu_torch.fft import dense
    from vkresample_tpu_torch.ops import cas_cuda, ycas_cuda
    from vkresample_tpu_torch.ops.cas import to_i16_storage
    from vkresample_tpu_torch.ops.weave import weave_rows_u8
    from vkresample_tpu_torch.pipeline.upscale import fp32_matmul

    card = gpu_line()
    print(f"{card}  torch {torch.__version__} cuda {torch.version.cuda}  package "
          f"{os.path.dirname(ycas_cuda.__file__)}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def gemm(U, T2, YT):
        with fp32_matmul():
            return ycas_cuda.ycas_odd_rows_reference(U, T2, YT)[1]

    def unfused(U, T2, YT):
        O = gemm(U, T2, YT)
        return cas_cuda.cas_parity_planes_u2(U, to_i16_storage(O) if U.dtype == torch.int16
                                             else O, 0.2)

    kernels = {
        "K8": (ycas_cuda.ycas_parity_u2, ycas_cuda.ycas_parity_u2_reference, unfused),
        "K9": (ycas_cuda.ycas_u2, ycas_cuda.ycas_u2_reference,
               lambda *a: weave_rows_u8(*unfused(*a))),
    }
    for shape in SHAPES:
        c, h, W = shape
        YT = torch.from_numpy(dense.ycas_bank(UpscalePlan(h=h, w=W // 2, upscale=2.0))).to(dev)
        r = YT.shape[1] - h
        for dt in (torch.int16, torch.float32):
            U = torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1
            U = to_i16_storage(U) if dt == torch.int16 else U
            T2 = torch.rand((c, r, W), generator=gen, device=dev) * 0.1 - 0.05
            args = (U, T2, YT)
            b_tc, by = ycas_bound(*args)
            b_fma = ycas_bound(*args, tensor_cores=False)[0]
            for kid, (fn, plain, pair) in kernels.items():
                got = fn(*args, 0.2)
                with fp32_matmul():
                    want = plain(*args, 0.2)
                d, same = u8_diff(got if isinstance(got, tuple) else (got,),
                                  want if isinstance(want, tuple) else (want,))
                device = graph_ms(lambda: fn(*args, 0.2), 50)
                eager = cuda_ms(lambda: fn(*args, 0.2), 50)
                print(f"[{kid}] U {shape} {dt}: device {device:.4f} ms, eager {eager:.4f} ms; "
                      f"max|diff| {d} LSB, identical {same:.6f}; bound {b_tc:.4f} ms ({by}, "
                      f"3xTF32 at 495 TFLOP/s; share {b_tc / device:.3f}), fp32 FMA form "
                      f"{b_fma:.4f} ms (share {b_fma / device:.3f}) on {card}; {root}")
                pair_ms = graph_ms(lambda: pair(*args), 50)
                print(f"[{kid} unfused] U {shape} {dt}: device {pair_ms:.4f} ms (cuBLAS y GEMM"
                      f"{' + Q2.14 store of O' if dt == torch.int16 else ''} + K2"
                      f"{' + weave' if kid == 'K9' else ''}) on {card}; {root}")
            print(f"[y GEMM] U {shape} {dt}: device {graph_ms(lambda: gemm(*args), 50):.4f} ms "
                  f"(torch.matmul, full fp32) on {card}; {root}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
