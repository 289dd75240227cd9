"""Flag-compatible CLI, single-image mode (counterpart of
vkresample_tpu/cli.py).

    python -m vkresample_tpu_torch -i in.png -o out.png -u 2 -p 2 -n 20 -validate

Flags and defaults are the reference's (VkResample.cpp:1795-1977):
-h -devices -d X -u X (default 1) -p X (default 0) -s X (default 0.2)
-n X (default 1) -i NAME -o NAME, plus the JAX CLI's -engine X, -c2c and
-validate.  Parsing is the same hand-rolled argv scan as the JAX CLI
(findFlag/getFlagValue semantics, VkResample.cpp:1782-1794).  The batched
folder flags and -profile are not ported yet (ROADMAP.md modules items 7
and 11).

The command line runs on CUDA device -d and exits 1 without one; only a
Python caller of main() may ask for the CPU (device="cpu"), which runs the
kernels' plain versions.
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
	-p X: specify precision (0 - single, 2 - half; 1 - double is not ported yet; default - single)
	-s X: specify sharpening factor, range 0.0-0.2 (default 0.2)
	-n X: specify how many times to perform upscale. This removes dispatch overhead and will show the real application performance (default 1)
Single image mode:
	-i NAME: specify input png file path
	-o NAME: specify output png file path (default X_X_upscaled.png)
Extras:
	-engine X: FFT engine: auto (default), mxu (dense GEMMs), xla (torch.fft reference tier)
	-c2c: use the full-complex spectrum path instead of R2C
	-validate: cross-check the output against the fp64 NumPy oracle
"""

# per-precision uint8 validation tolerance against the fp64 oracle (the JAX
# CLI's _VALIDATE_TOL)
_VALIDATE_TOL = {0: 1, 1: 1, 2: 1}

_NOT_PORTED_FLAGS = {
    "-ifolder": "batched folder mode (ROADMAP.md modules item 7)",
    "-ofolder": "batched folder mode (ROADMAP.md modules item 7)",
    "-numfiles": "batched folder mode (ROADMAP.md modules item 7)",
    "-numthreads": "batched folder mode (ROADMAP.md modules item 7)",
    "-batch": "batched folder mode (ROADMAP.md modules item 7)",
    "-resume": "batched folder mode (ROADMAP.md modules item 7)",
    "-profile": "profiling (ROADMAP.md modules item 11)",
}


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
    return ResampleConfig(**kw), {"validate": find_flag(argv, "-validate"),
                                  "c2c": find_flag(argv, "-c2c")}


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


def device_list_string() -> str:
    import torch

    if not torch.cuda.is_available():
        return "No CUDA devices found."
    return "\n".join(
        f"Device id: {i} name: {torch.cuda.get_device_name(i)}"
        for i in range(torch.cuda.device_count())
    )


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


def run_single(cfg, extras, device) -> int:
    import numpy as np
    import torch

    from .core.config import default_output_name
    from .io import png
    from .pipeline.timing import time_amortized
    from .pipeline.upscale import build_upscale, planes_format

    try:
        img = png.read_png(cfg.input_path)
    except FileNotFoundError:
        print("Image not found")
        return 1
    h, w = img.shape[:2]
    plan = _make_plan(cfg, extras, h, w)
    device = torch.device(device)
    print("Device: " + (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else f"{device} (plain PyTorch versions)"))
    # u=2 r2c plans and c2c grid plans emit the fused CAS kernels' parity
    # planes ('quad', 'rows' or 'grid'), which the PNG encoder weaves in its
    # row loop; the rest emit the planar (C, H, W) image
    fmt = planes_format(plan)
    fn = build_upscale(plan, device, planes_out=fmt is not None, planar_out=True)
    x = torch.from_numpy(img).to(device)
    out, ms = time_amortized(fn, (x,), cfg.num_iter, device)
    print(
        "vkresample-tpu-torch %0.1fx upscale: %dx%d to %dx%d Time: %0.3f ms"
        % (cfg.upscale, w, h, plan.W, plan.H, ms)
    )
    out_path = cfg.output_path or default_output_name(w, cfg.upscale)
    # quad: 4x (3, H/2, W/2); rows: (E, D), each (3, H/2, W); grid: p^2 x
    # (3, H/p, W/p); else (3, H, W)
    planes = [p.cpu().numpy() for p in out] if fmt else [out.cpu().numpy()]
    p = int(round(len(planes) ** 0.5))  # grid phase count
    rc = 0
    if extras.get("validate"):
        if fmt == "quad":
            woven = png.weave4_host(*planes)
        elif fmt == "grid":
            woven = png.weave_grid_host(planes, p)
        elif fmt == "rows":
            woven = np.stack(planes, axis=2).reshape(3, plan.H, plan.W)
        else:
            woven = planes[0]
        rc = _validate(img, np.moveaxis(woven, 0, -1), plan)
    if fmt == "quad":
        png.write_png_planar_parity4(out_path, planes)
    elif fmt == "grid":
        png.write_png_planar_grid(out_path, planes, p)
    elif fmt == "rows":
        png.write_png_planar_parity(out_path, *planes)
    else:
        png.write_png_planar(out_path, planes[0])
    return rc


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
        print(device_list_string())
        return 0
    for flag, what in _NOT_PORTED_FLAGS.items():
        if find_flag(argv, flag):
            print(f"Error: {flag}: {what} is not ported yet")
            return 1

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
    print("vkresample-tpu-torch - FFT based upscaling")
    t0 = time.perf_counter()
    try:
        rc = run_single(cfg, extras, device)
    except (ValueError, NotImplementedError) as e:
        # plan/geometry errors and plans outside the ported slice: a clean
        # message, like the reference's scheduler error paths
        print(f"Error: {e}")
        return 1
    print("Total time: %0.3f s" % (time.perf_counter() - t0))
    return rc


if __name__ == "__main__":
    sys.exit(main())
