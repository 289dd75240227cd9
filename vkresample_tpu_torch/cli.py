"""Flag-compatible CLI, single-image and batched-folder modes (counterpart
of vkresample_tpu/cli.py).

    python -m vkresample_tpu_torch -i in.png -o out.png -u 2 -p 2 -n 20 -validate
    python -m vkresample_tpu_torch -ifolder inp -ofolder outp -numfiles 24 -numthreads 8 -u 2 -p 2

Flags and defaults are the reference's (VkResample.cpp:1795-1977):
-h -devices -d X -u X (default 1) -p X (default 0) -s X (default 0.2)
-n X (default 1) -i NAME -o NAME -ifolder X -ofolder X -numfiles X
-numthreads X, plus the JAX CLI's -engine X, -c2c, -batch X, -resume,
-validate and -profile DIR (a torch.profiler trace of the single-image
mode's timed region, utils/profiling.py).  Parsing is the same hand-rolled
argv scan as the JAX CLI (findFlag/getFlagValue semantics,
VkResample.cpp:1782-1794).

The command line runs on CUDA device -d and exits 1 without one; with
more than one visible card the folder mode shards each batch over all of
them, as the JAX CLI does over all its devices.  Only a Python caller of
main() may ask for the CPU (device="cpu", or a list of devices for the
folder mode), which runs the kernels' plain versions.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

HELP = """\
vkresample-tpu-torch v{version} — PyTorch/CUDA port of vkresample-tpu (capabilities of VkResample v1.0.2)
Works with png images only, for now!
	-h: print help
	-devices: print the list of available CUDA devices
	-d X: select device (default 0)
	-u X: specify upscale factor (float, default 1; output dims must be 7-smooth for the mxu engine)
	-p X: specify precision (0 - single, 1 - double, 2 - half, default - single)
	-s X: specify sharpening factor, range 0.0-0.2 (default 0.2)
	-n X: specify how many times to perform upscale. This removes dispatch overhead and will show the real application performance (default 1)
Single image mode:
	-i NAME: specify input png file path
	-o NAME: specify output png file path (default X_X_upscaled.png)
Batched mode:
	-ifolder X: specify input folder plus file prefix, like inp/img
	-ofolder X: specify output folder plus file prefix, like outp/img
	-numfiles X: specify how many images to upscale. They should have names like prefix + 000001.png with numbers padded with zeros to six digits. Temporary limitation.
	-numthreads X: specify how many threads to launch. Used to speed up png reads
Extras:
	-engine X: FFT engine: auto (default), mxu (dense GEMMs), xla (torch.fft reference tier)
	-c2c: use the full-complex spectrum path instead of R2C
	-batch X: frames per device dispatch in batched mode (default: auto)
	-validate: cross-check the output against the fp64 NumPy oracle
	-profile DIR: capture a device profiler trace of the timed region
	-resume: batched mode: skip frames whose output file already exists
"""

# per-precision uint8 validation tolerance against the fp64 oracle (the JAX
# CLI's _VALIDATE_TOL)
_VALIDATE_TOL = {0: 1, 1: 1, 2: 1}


def find_flag(argv: List[str], flag: str) -> bool:
    return flag in argv


def get_flag_value(argv: List[str], flag: str) -> Optional[str]:
    try:
        i = argv.index(flag)
    except ValueError:
        return None
    if i + 1 < len(argv):
        return argv[i + 1]
    return None


def _parse(argv: List[str]):
    """Parse argv into a ResampleConfig + extras; returns None on error."""
    from .core.config import Engine, Precision, ResampleConfig

    def req(flag, msg):
        v = get_flag_value(argv, flag)
        if v is None:
            print(msg)
        return v

    kw = {}
    if find_flag(argv, "-d"):
        v = req("-d", "No device is selected with -d flag")
        if v is None:
            return None
        kw["device_id"] = int(v)
    if find_flag(argv, "-n"):
        v = req("-n", "No number is selected with -n flag")
        if v is None:
            return None
        kw["num_iter"] = int(v)
    if find_flag(argv, "-p"):
        v = req("-p", "No precision is selected with -p flag")
        if v is None:
            return None
        kw["precision"] = Precision(int(v))
    if find_flag(argv, "-s"):
        v = req("-s", "No sharpening parameter is selected with -s flag")
        if v is None:
            return None
        kw["sharpen"] = float(v)
    if find_flag(argv, "-u"):
        v = get_flag_value(argv, "-u")
        if v is None:
            print("No proper upscale factor is selected with -u flag, default 1")
        else:
            kw["upscale"] = float(v)
    else:
        print("No upscale factor is selected with -u flag, default 1")
    if find_flag(argv, "-engine"):
        v = req("-engine", "No engine is selected with -engine flag")
        if v is None:
            return None
        kw["engine"] = Engine(v)
    if not find_flag(argv, "-ifolder"):
        v = get_flag_value(argv, "-i")
        if v is None:
            print("No input file is selected with -i flag")
            return None
        kw["input_path"] = v
        if find_flag(argv, "-o"):
            v = req("-o", "No output file is selected with -o flag")
            if v is None:
                return None
            kw["output_path"] = v
    else:
        v = get_flag_value(argv, "-ifolder")
        if v is None:
            print("No input folder+prefix is selected with -ifolder flag")
            return None
        kw["ifolder_prefix"] = v
        for flag, key, msg, conv in (
            ("-ofolder", "ofolder_prefix",
             "No output folder+prefix is selected with -ofolder flag", str),
            ("-numthreads", "num_threads", "No numThreads is selected with -numthreads flag", int),
            ("-numfiles", "num_files", "No numFiles is selected with -numfiles flag", int),
        ):
            if find_flag(argv, flag):
                v = req(flag, msg)
                if v is None:
                    return None
                kw[key] = conv(v)
    return ResampleConfig(**kw), {"validate": find_flag(argv, "-validate"),
                                  "c2c": find_flag(argv, "-c2c"),
                                  "batch": int(get_flag_value(argv, "-batch") or 0),
                                  "resume": find_flag(argv, "-resume"),
                                  "profile": get_flag_value(argv, "-profile")}


def _validate(img, out_np, plan) -> int:
    """Cross-check one frame against the port's fp64 oracle."""
    import numpy as np

    from .oracle.numpy_ref import upscale_oracle

    want = upscale_oracle(np.asarray(img), plan)
    diff = int(np.max(np.abs(out_np.astype(np.int64) - want.astype(np.int64))))
    tol = _VALIDATE_TOL[int(plan.precision)]
    status = "OK" if diff <= tol else "FAIL"
    print(f"Validation vs fp64 oracle: maxdiff={diff} LSB (tol {tol}) {status}")
    return 0 if diff <= tol else 1


def _make_plan(cfg, extras, h: int, w: int):
    """The plan of one frame; output dims must be 7-smooth when the engine
    resolves to the dense GEMM tier (vkresample_tpu/cli.py:178-194)."""
    from .core.config import Engine
    from .core.plan import UpscalePlan

    plan = UpscalePlan(
        h=h, w=w, upscale=cfg.upscale, precision=cfg.precision,
        sharpen=cfg.sharpen, r2c=not extras["c2c"], engine=cfg.engine,
    )
    if plan.resolve_engine() is Engine.MXU:
        plan.validate_7smooth()
    return plan


def _hbm_estimate_mb(plan) -> int:
    """Printed device-memory footprint, the JAX CLI's estimate
    (vkresample_tpu/cli.py:197-203), mirroring the reference's VRAM line
    (VkResample.cpp:1450: inputBufferSize + 2*bufferSize)."""
    cs = 16 if plan.precision.name == "DOUBLE" else 8  # complex element bytes
    small = 3 * (plan.w // 2 + 1) * plan.h * cs
    big = 3 * (plan.W // 2 + 1) * plan.H * cs
    return (small + 2 * big) // 1024 // 1024


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return f"{device} (plain PyTorch versions)"


def run_single(cfg, extras, device) -> int:
    import torch

    from .core.config import default_output_name
    from .core.tuning import plan_for
    from .io import png
    from .pipeline.timing import time_amortized
    from .pipeline.upscale import build_upscale, planes_format
    from .utils.profiling import maybe_trace

    try:
        img = png.read_png(cfg.input_path)
    except FileNotFoundError:
        print("Image not found")
        return 1
    except (OSError, ValueError) as e:  # a file that exists but does not decode
        print(f"Error: {e}")
        return 1
    h, w = img.shape[:2]
    plan = _make_plan(cfg, extras, h, w)
    print(f"HBM per device: {_hbm_estimate_mb(plan)} MB")
    device = torch.device(device)
    print("Device: " + _device_name(device))
    plan = plan_for(plan, device)  # the card's dense cap picks the tier
    # u=2 r2c plans and c2c grid plans emit the fused CAS kernels' parity
    # planes ('quad', 'rows' or 'grid'), which the PNG encoder weaves in its
    # row loop; the rest emit the planar (C, H, W) image
    fmt = planes_format(plan)
    fn = build_upscale(plan, device, planes_out=fmt is not None, planar_out=True)
    x = torch.from_numpy(img).to(device)
    with maybe_trace(extras.get("profile")):
        out, ms = time_amortized(fn, (x,), cfg.num_iter, device)
    print(
        "vkresample-tpu-torch %0.1fx upscale: %dx%d to %dx%d Time: %0.3f ms"
        % (cfg.upscale, w, h, plan.W, plan.H, ms)
    )
    out_path = cfg.output_path or default_output_name(w, cfg.upscale)
    with png.PngPool(1) as pool:  # the frame as a batch of one
        _encode_chunk(pool, fmt, [out_path], tuple(p[None] for p in out) if fmt else out[None])
    # PNG is lossless: the file read back is the frame the device made
    return _validate(img, png.read_png(out_path), plan) if extras.get("validate") else 0


def _encode_chunk(pool, fmt, paths, res) -> None:
    """Move a batch's device output to the host and encode it, one path per
    frame: planar (N, 3, H, W) frames, or the parity planes of
    planes_format, each (N, 3, ...), which the encoder weaves; a list of
    them (one per device of a "dp" batch) is joined in frame order, and
    frames past len(paths) (a tail's zero padding) are dropped.  The one
    place the CLI maps a plane layout to its writer (run_single passes a
    batch of one)."""
    import torch

    n = len(paths)
    if fmt is None:
        res = torch.cat([r.cpu() for r in res]) if isinstance(res, list) else res.cpu()
        pool.encode_batch_planar(paths, res[:n].numpy())
        return
    if isinstance(res, list):
        res = [torch.cat([r[i].cpu() for r in res]) for i in range(len(res[0]))]
    planes = [p[:n].cpu().numpy() for p in res]
    if fmt == "quad":
        pool.encode_batch_planar_parity4(paths, planes)
    elif fmt == "rows":
        pool.encode_batch_planar_parity(paths, *planes)
    else:  # grid: p^2 planes (p = integer u, or the numerator of p/q)
        pool.encode_batch_planar_grid(paths, planes, int(round(len(planes) ** 0.5)))


def run_batched(cfg, extras, device) -> int:
    """Batched-folder mode (vkresample_tpu/cli.py run_batched): frames
    prefix/000001.png ... in chunks of -batch frames, one batched call per
    chunk; the next chunk decodes on the host while the device works on the
    current one.  device may be a list of devices: each chunk then splits
    evenly over them (the JAX CLI's "dp" mesh), the batch rounded to a
    device multiple as there, a short tail padded with zero frames to one."""
    import os

    import numpy as np
    import torch

    from .core.tuning import plan_for
    from .io.folder import frame_paths
    from .io.png import PngPool, read_png
    from .parallel.mesh import batch_for_devices, data_parallel_devices
    from .pipeline.batched import build_batched_upscale
    from .pipeline.upscale import planes_format

    in_paths = frame_paths(cfg.ifolder_prefix, cfg.num_files)
    out_paths = frame_paths(cfg.ofolder_prefix or cfg.ifolder_prefix, cfg.num_files)
    if extras.get("resume"):
        # resume by file index: the %06d.png names make the batch resumable
        keep = [i for i, p in enumerate(out_paths) if not os.path.exists(p)]
        skipped = cfg.num_files - len(keep)
        if skipped:
            print(f"Resume: skipping {skipped} already-upscaled frames")
        in_paths = [in_paths[i] for i in keep]
        out_paths = [out_paths[i] for i in keep]
        if not in_paths:
            print("Resume: nothing to do")
            return 0
    if not in_paths:
        raise ValueError(f"-numfiles takes a positive frame count, got {cfg.num_files}")
    try:
        first = read_png(in_paths[0])
    except FileNotFoundError:
        print("Image not found")
        return 1
    h, w = first.shape[:2]
    plan = _make_plan(cfg, extras, h, w)
    print(f"HBM per device: {_hbm_estimate_mb(plan)} MB")
    devices = (data_parallel_devices(device) if isinstance(device, (list, tuple))
               else [torch.device(device)])
    n_dev = len(devices)
    n_files = len(in_paths)
    if extras["batch"] < 0:
        raise ValueError(f"-batch takes a positive frame count, got {extras['batch']}")
    batch = batch_for_devices(extras["batch"], n_files, n_dev)
    # planar device output and planar encode: no layout transpose on either
    # side of the PNG boundary; parity-plane routes are woven by the encoder.
    # Each card's cap picks its tier: cards whose layouts differ give woven
    # frames
    fmts = {planes_format(plan_for(plan, d)) for d in devices}
    fmt = fmts.pop() if len(fmts) == 1 else None
    fn = build_batched_upscale(plan, devices if n_dev > 1 else devices[0], planar_out=True,
                               planes_out=fmt is not None)

    t0 = time.perf_counter()
    done = 0
    with PngPool(cfg.num_threads) as pool:
        idx = 0
        pending = None  # (out paths, device result) of the chunk in flight
        while idx < n_files or pending is not None:
            chunk = in_paths[idx:idx + batch]
            imgs = pool.decode_batch(chunk, w, h) if chunk else None
            if pending is not None:
                _encode_chunk(pool, fmt, *pending)
                done += len(pending[0])
                pending = None
            if imgs is not None:
                # a short tail runs at its own size (eager calls compile no
                # shape), padded only to split evenly over the devices
                pad = -len(imgs) % n_dev
                if pad:
                    imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                x = torch.from_numpy(imgs)
                pending = (out_paths[idx:idx + batch], fn(x if n_dev > 1 else x.to(devices[0])))
            idx += batch
    dt = time.perf_counter() - t0
    print(
        "Upscaled %d frames %dx%d -> %dx%d in %0.3f s (%0.2f frames/s)"
        % (done, w, h, plan.W, plan.H, dt, done / dt if dt > 0 else 0.0)
    )
    # the reference's completion line: "Thread %d finished. Device name:
    # %s ..." (VkResample.cpp:1773)
    print(f"Finished. Device name: {_device_name(devices[0])} ({n_dev} device(s))")
    return 0


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the CLI on argv (default sys.argv[1:]).  device: None (the
    command line) runs on CUDA device -d and exits 1 without one; a Python
    caller may name another device ("cpu" runs the plain versions)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    from . import __version__

    if find_flag(argv, "-h") or not argv:
        print(HELP.format(version=__version__))
        return 0
    if find_flag(argv, "-devices"):
        from .parallel.mesh import device_list_string

        print(device_list_string())
        return 0
    parsed = _parse(argv)
    if parsed is None:
        return 1
    cfg, extras = parsed
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print("Error: no CUDA device")
            return 1
        device = f"cuda:{cfg.device_id}"
        if cfg.file_upload and torch.cuda.device_count() > 1:
            # folder batches shard over every visible card, as the JAX CLI
            # shards them over every device
            from .parallel.mesh import data_parallel_devices

            device = data_parallel_devices()
    print("vkresample-tpu-torch - FFT based upscaling")
    t0 = time.perf_counter()
    try:
        rc = (run_batched if cfg.file_upload else run_single)(cfg, extras, device)
    except (ValueError, NotImplementedError, OSError) as e:
        # plan/geometry errors, plans outside the ported slice, a frame of a
        # folder run that is missing or cannot be written: a clean message,
        # like the reference's scheduler error paths
        print(f"Error: {e}")
        return 1
    print("Total time: %0.3f s" % (time.perf_counter() - t0))
    return rc


if __name__ == "__main__":
    sys.exit(main())
