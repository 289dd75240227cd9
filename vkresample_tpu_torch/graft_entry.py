"""Whole-program entry points of the port (counterpart of the root
__graft_entry__.py, which runs the JAX package):

    entry(device=None)              -> (fn, example_args): the flagship
                                       forward step, fn(*example_args) is
                                       the (512, 1024, 3) uint8 frame
    dryrun_multichip(n, device=None) -> one step of every multi-device
                                       path over n devices, each held
                                       within 1 LSB of the one-device call

Both run on the current CUDA device unless the caller names another
(device="cpu" runs the kernels' plain versions); without a card and
without that request they raise RuntimeError (core/config.py::
resolve_device).  There is no virtual mesh: n devices are n entries of a
device list, repeats allowed, and the sp step starts n processes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .core.config import Engine, Precision, fp32_matmul, resolve_device
from .core.plan import UpscalePlan
from .core.tuning import plan_for
from .fft import mxu_pipeline
from .parallel import distributed as sp
from .parallel.launch import spawn
from .parallel.mesh import data_parallel_devices
from .parallel.sp_run import sp_frames
from .pipeline import upscale as pipe
from .pipeline.batched import build_batched_upscale

TOL_LSB = 1
STAGED_CAP = 64  # step 4's dense cap: the 32x128 and 96x120 plans pass it
SPAWN_TIMEOUT_S = 300.0


def _step(img, banks, plan, engine):
    with fp32_matmul():  # as every built pipeline's call (pipeline/upscale.py)
        return pipe._pipeline(img, banks, plan, engine, False, False)


def entry(device=None):
    """The flagship single-frame forward of JAX's entry(): 2x FFT upscale +
    CAS sharpen, half storage (uint8 in, fp32 compute, int16 Q2.14
    pre-CAS planes), MXU engine, at 256x512 (the moderate flagship shape
    that keeps a compile check fast).  fn(img, banks) -> the (512, 1024,
    3) uint8 frame on the device; example_args are a zero image and the
    plan's banks on the device (make_device_banks)."""
    device = resolve_device(device)
    plan = plan_for(UpscalePlan(h=256, w=512, upscale=2.0, precision=Precision.HALF,
                                sharpen=0.2, engine=Engine.MXU), device)
    engine = pipe.route_engine(plan)
    fn = functools.partial(_step, plan=plan, engine=engine)
    img = torch.zeros((plan.h, plan.w, 3), dtype=torch.uint8, device=device)
    return fn, (img, pipe.make_device_banks(plan, engine, device, planes_out=False))


def _require(cond: bool, msg) -> None:
    """A dryrun check that holds under python -O too."""
    if not cond:
        raise AssertionError(msg)


def _max_lsb(got, want) -> int:
    """Largest |difference| between two uint8 outputs: tensors, or tuples
    or lists of them (a "dp" list is joined in frame order)."""
    def flat(x):
        if isinstance(x, (list, tuple)) and x and isinstance(x[0], (list, tuple)):
            return [torch.cat([part[i].cpu() for part in x]) for i in range(len(x[0]))]
        if isinstance(x, list):
            return [torch.cat([part.cpu() for part in x])]
        return [p.cpu() for p in x] if isinstance(x, tuple) else [x.cpu()]

    a, b = flat(got), flat(want)
    _require(len(a) == len(b) and all(p.shape == q.shape for p, q in zip(a, b)),
             f"outputs of different layouts: {[tuple(p.shape) for p in a]}, "
             f"{[tuple(q.shape) for q in b]}")
    return max(int((p.to(torch.int16) - q.to(torch.int16)).abs().max()) for p, q in zip(a, b))


def _check(step: str, got, want, diffs: dict) -> None:
    d = diffs[step] = _max_lsb(got, want)
    _require(d <= TOL_LSB, f"{step}: {d} LSB from the one-device call")


def _dp_devices(n: int, device):
    """n "dp" entries: the named device n times, else the cards in turn."""
    if device is not None:
        return data_parallel_devices([device] * n)
    cards = data_parallel_devices()
    return [cards[i % len(cards)] for i in range(n)]


def _sp_cases(n: int):
    """JAX's seven sp steps (__graft_entry__.py:174-227) as (form, plan,
    frame) cases of parallel/sp_run.py::sp_frames."""
    rng = np.random.default_rng(1)
    plan = UpscalePlan(h=16 * n, w=64, upscale=2.0, precision=Precision.HALF)
    frame = rng.integers(0, 256, size=(plan.h, plan.w, 3), dtype=np.uint8)
    cases = [("dense", plan, frame), ("rows", plan, frame)]
    rng = np.random.default_rng(2)
    for form, u, r2c, hw in (("staged", 2.0, True, None), ("grid", 3.0, True, None),
                             ("grid", 1.5, True, None), ("grid", 4.0 / 3.0, True, (24 * n, 384)),
                             ("c2c_grid", 2.0, False, None)):
        p = UpscalePlan(h=hw[0] if hw else 16 * n, w=hw[1] if hw else 256, upscale=u, r2c=r2c,
                        precision=Precision.HALF)
        cases.append((form, p, rng.integers(0, 256, size=(p.h, p.w, 3), dtype=np.uint8)))
    return cases


def dryrun_multichip(n: int, device=None) -> dict:
    """One step of each multi-device path over n devices, JAX's
    dryrun_multichip step for step (__graft_entry__.py:84-227):

      1. dp       a batch of 2n frames (32x64, u=2, -p 2) over n devices:
                  each device's share (2, 64, 128, 3) uint8
      2. planes   the same batch, parity-plane output
      3. serial   steps 1 and 2 with every frame on the channel-serial
                  path (CHANNEL_SERIAL_ELEMS lowered for the step)
      4. staged   the staged quad at 32x128 and 96x120, the plans'
                  dense cap 64 (JAX lowers DENSE_MAX to 64), planes out
      5. sp       JAX's seven pencil cases (dense, rows, staged, grid u=3,
                  1.5 and 4/3, c2c grid) at S = n ranks started by
                  parallel/launch.py::spawn: NCCL where there are n cards,
                  else gloo

    device: None for the cards ("dp" entries take them in turn; the sp
    ranks take cuda:{rank % count}), or one device that every entry and
    rank uses ("cpu" runs the plain versions).  Each step checks shapes and
    dtypes and holds its output within 1 LSB of the one-device call on the
    same frames (for sp: upscale() of the whole frame); returns {step: max
    |difference| in LSB}."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    one = resolve_device(device)  # raises without a card, unless device is named
    devs = _dp_devices(n, device)
    diffs = {}

    plan = UpscalePlan(h=32, w=64, upscale=2.0, precision=Precision.HALF, sharpen=0.2,
                       engine=Engine.AUTO)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(2 * n, plan.h, plan.w, 3), dtype=np.uint8))
    # 1. a dp batch
    out = build_batched_upscale(plan, devs)(imgs)
    _require(len(out) == n and all(o.shape == (2, plan.H, plan.W, 3) and o.dtype == torch.uint8
                                   for o in out), f"dp: {[tuple(o.shape) for o in out]}")
    woven = build_batched_upscale(plan, one)(imgs)
    _check("dp", out, woven, diffs)
    # 2. parity-plane output over dp
    planes = build_batched_upscale(plan, devs, planar_out=True, planes_out=True)(imgs)
    _require(len(planes) == n and all(
        isinstance(part, tuple) and len(part) in (2, 4)
        and all(p.dtype == torch.uint8 and p.shape[0] == 2 for p in part) for part in planes),
        "planes: not n tuples of 2 or 4 uint8 planes of 2 frames")
    one_planes = build_batched_upscale(plan, one, planar_out=True, planes_out=True)(imgs)
    _check("planes", planes, one_planes, diffs)
    # 3. the channel-serial path, over the same dp devices
    saved = pipe.CHANNEL_SERIAL_ELEMS
    pipe.CHANNEL_SERIAL_ELEMS = 0
    try:
        _require(pipe._channel_serial(plan, imgs), "serial: the frames are not channel-serial")
        splanes = build_batched_upscale(plan, devs, planar_out=True, planes_out=True)(imgs)
        _require(all(p.shape == q.shape and p.dtype == torch.uint8
                     for part, ref in zip(splanes, planes) for p, q in zip(part, ref)),
                 "serial planes: shapes or dtypes differ from the batched planes")
        _check("serial planes", splanes, one_planes, diffs)
        sw = build_batched_upscale(plan, devs)(imgs)
        _require(all(o.shape == (2, plan.H, plan.W, 3) for o in sw),
                 f"serial: {[tuple(o.shape) for o in sw]}")
        _check("serial", sw, woven, diffs)
    finally:
        pipe.CHANNEL_SERIAL_ELEMS = saved
    # 4. dp plans on the staged tier: the plans carry a cap of 64 as their
    # own (the small-shape analog of a frame past 8192), an aligned and a
    # non-128-aligned width; a card's row (core/tuning.py) does not override
    # a plan's cap, and the pipeline cache keys on it
    for h, w in ((32, 128), (96, 120)):
        st_plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF, sharpen=0.2,
                              engine=Engine.MXU, dense_max=STAGED_CAP)
        _require(mxu_pipeline.bank_set(st_plan) == "staged",
                 f"staged {h}x{w}: bank set {mxu_pipeline.bank_set(st_plan)}")
        stimgs = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, size=(2 * n, h, w, 3), dtype=np.uint8))
        souts = build_batched_upscale(st_plan, devs, planes_out=True)(stimgs)
        _require(all(isinstance(part, tuple) and len(part) == 4 for part in souts),
                 f"staged {h}x{w}: not four quad planes a device")
        _check(f"staged {h}x{w}", souts,
               build_batched_upscale(st_plan, one, planes_out=True)(stimgs), diffs)
    # 5. the sp pencil forms, one frame over S = n ranks
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if device is None and cards >= n else "gloo"
    cases = _sp_cases(n)
    ranks = spawn(n, sp_frames, (cases, device), backend=backend, timeout_s=SPAWN_TIMEOUT_S)
    for i, (form, p, frame) in enumerate(cases):
        got = sp.gather_blocks([torch.from_numpy(r[i]["block"]) for r in ranks],
                               sp.OUTPUT_AXIS[form])
        _require(got.shape == (p.H, p.W, 3) and got.dtype == torch.uint8,
                 f"sp {form}: {tuple(got.shape)} {got.dtype}")
        _check(f"sp {form} {p.w}x{p.h} x{p.upscale:g}", got,
               pipe.upscale(frame, p.upscale, plan=p, device=one), diffs)
    return diffs
