"""Build variants of the streaming pipeline's sizes, hold each against the
plain versions, and time K7 and K10b on the device alone, in one process.

    python3 scripts/torch_stream_tune.py [--parent DIR] NAME:KEY=VALUE,... ...

Each NAME:KEY=VALUE,... is a variant: a copy of vkresample_tpu_torch/csrc
whose csrc/stream_pipeline.cuh has the named constants (kRows, kStages,
kConsumers, kMinBlocks) set to the values given ("NAME:" alone keeps them),
with cas_mono.cu (K7) and copy_quantize.cu (K10b) built by nvcc for sm_90a
into a library of its own (registers and spills from -Xptxas -v printed).
--parent DIR adds the checkout at DIR's two sources as the variant
"parent", so one call times a parent and its change on one card.

For every variant, on seeded float32 images on the card:

  check   K7 and K10b at the pipeline's edges (the A/B frame at bh 64, 128,
          1 and 1000, bh past H, W = 4100 and 4097, H = 1, W = 1, H one
          row past a segment multiple, 24 planes, views one float off a
          16-byte boundary): K7 equal on every pixel to its plain version
          and to K3, K10b to the plain quantize; each call bounded in time
  device  ms per call of 50 calls replayed from one CUDA graph
          (chip_smoke.py::graph_ms) at (3, 2048, 4096) and (3, 2160, 3840),
          bh 64 and 128, the variants in the order given and back, twice,
          with the bound (the image read once and written once as uint8
          over 3.35 TB/s) and its share; K3 and K10c of the checkout beside
          them; then bh 1, 8, 16, 32 and 256 once at (3, 2048, 4096)

with the card's name and power limit.  Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("cas_mono.cu", "copy_quantize.cu")


def build_all(variants, work):
    """{name: ctypes library} for [(name, csrc dir, {constant: value})],
    compiled concurrently."""
    from vkresample_tpu_torch import _build

    nvcc, jobs = _build._nvcc(), []
    for name, csrc, subs in variants:
        d = os.path.join(work, name)
        shutil.copytree(csrc, d)
        hdr = os.path.join(d, "stream_pipeline.cuh")
        if subs:
            text = open(hdr).read()
            for key, value in subs.items():
                text, n = re.subn(rf"(constexpr \w+ {key} = )[^;]+;", rf"\g<1>{value};", text)
                if n != 1:
                    raise SystemExit(f"{name}: no constant {key} in {hdr}")
            open(hdr, "w").write(text)
        cmds = [[nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", f"{d}/{s}.o", f"{d}/{s}"]
                for s in SOURCES]
        jobs.append((name, d, [subprocess.Popen(c, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
                               for c in cmds]))
    libs = {}
    for name, d, procs in jobs:
        for proc in procs:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
            for line in log.splitlines():
                if "registers" in line or "spill stores" in line:
                    print(f"[{name}] {line.strip()}")
        so = os.path.join(d, "lib.so")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so,
                        *[f"{d}/{s}.o" for s in SOURCES]], check=True)
        lib = ctypes.CDLL(so)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vkr_cas_mono.argtypes = [P, P, I, I, I, I, F, P]
        lib.vkr_copy_quantize_mono.argtypes = [P, P, I, I, I, I, P]
        libs[name] = lib
    return libs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the variants need one GPU")
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import bounded_sync, gpu_line, graph_ms

    from vkresample_tpu_torch.ops import cas_cuda, quantize_cuda

    variants = []
    if argv[:1] == ["--parent"]:
        variants.append(("parent", os.path.join(argv[1], "vkresample_tpu_torch", "csrc"), {}))
        argv = argv[2:]
    for spec in argv:
        name, _, kv = spec.partition(":")
        subs = dict(item.split("=") for item in kv.split(",") if item)
        variants.append((name, os.path.join(ROOT, "vkresample_tpu_torch", "csrc"), subs))
    work = tempfile.mkdtemp(prefix="stream_tune_")
    try:
        t0 = time.perf_counter()
        libs = build_all(variants, work)
        card = gpu_line()
        print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s; {card}")
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(7)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def run(lib, kid, v, bh):
            out = torch.empty(v.shape, dtype=torch.uint8, device=dev)
            H, W = v.shape[-2:]
            args = (v.data_ptr(), out.data_ptr(), v.numel() // (H * W), H, W, bh)
            rc = (lib.vkr_cas_mono(*args, 0.2, stream()) if kid == "K7"
                  else lib.vkr_copy_quantize_mono(*args, stream()))
            if rc != 0:
                raise RuntimeError(f"{kid} launch failed: cudaError_t {rc}")
            return out

        def image(shape, offset=0):
            n = 1
            for d in shape:
                n *= d
            buf = torch.rand(n + offset, generator=gen, device=dev) * 1.3 - 0.1
            return buf[offset:].view(shape)

        cases = ([((3, 2048, 4096), bh, 0) for bh in (64, 128, 1, 1000)]
                 + [((2, 37, 201), bh, 0) for bh in (1, 7, 32, 128)]
                 + [((2, 64, 4100), 32, 0), ((2, 33, 4097), 32, 0), ((1, 1, 1), 1, 0),
                    ((1, 1, 1), 5, 0), ((1, 1, 4096), 3, 0), ((3, 1, 129), 1, 0),
                    ((2, 129, 256), 128, 0), ((2, 129, 256), 64, 0), ((2, 65, 4096), 64, 0),
                    ((24, 64, 512), 7, 0), ((3, 2160, 3840), 128, 0), ((2, 5, 8), 3, 0),
                    ((2, 300, 260), 1000, 0), ((2, 2, 4), 1, 0), ((2, 37, 200), 7, 1),
                    ((3, 256, 512), 64, 1)])
        for name, lib in libs.items():
            bad = 0
            for shape, bh, offset in cases:
                v = image(shape, offset)
                k7, k10b = run(lib, "K7", v, bh), run(lib, "K10b", v, bh)
                bounded_sync(f"{name} at {shape} bh {bh}", 60)
                ok = (torch.equal(k7, cas_cuda.cas_quantize_mono_reference(v, 0.2))
                      and torch.equal(k7, cas_cuda.cas_quantize(v, 0.2))
                      and torch.equal(k10b, quantize_cuda.copy_quantize_reference(v)))
                if not ok:
                    bad += 1
                    print(f"[{name}] differs at {shape} bh {bh} offset {offset}")
            print(f"[{name}] {len(cases) - bad} of {len(cases)} cases identical "
                  "(K7 = its plain version = K3; K10b = the plain quantize)")
            if bad:
                return 1

        order = list(libs) + list(libs)[::-1]
        for shape in ((3, 2048, 4096), (3, 2160, 3840)):
            v = image(shape)
            times = {}
            for _ in range(2):
                for name in order:
                    for bh in (64, 128):
                        for kid in ("K7", "K10b"):
                            times.setdefault((name, kid, bh), []).append(
                                graph_ms(lambda: run(libs[name], kid, v, bh), 50))
                for kid, fn in (("K3", lambda: cas_cuda.cas_quantize(v, 0.2)),
                                ("K10c", lambda: quantize_cuda.copy_quantize_rows(v))):
                    times.setdefault(("checkout", kid, None), []).append(graph_ms(fn, 50))
            bound = v.numel() * 5 / 3.35e12 * 1e3
            print(f"{shape}: bound {bound:.4f} ms (read once, uint8 written once, 3.35 TB/s)")
            for (name, kid, bh), ts in times.items():
                print(f"[{name}] {shape} {kid}" + ("" if bh is None else f" bh={bh}")
                      + ": device " + " ".join(f"{t:.4f}" for t in ts)
                      + f" ms, {bound / max(ts):.3f}-{bound / min(ts):.3f} of the bound on {card}")
        v = image((3, 2048, 4096))
        for bh in (1, 8, 16, 32, 256):
            for name, lib in libs.items():
                print(f"[{name}] bh={bh}: K7 {graph_ms(lambda: run(lib, 'K7', v, bh), 50):.4f}, "
                      f"K10b {graph_ms(lambda: run(lib, 'K10b', v, bh), 50):.4f} ms on {card}")
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
