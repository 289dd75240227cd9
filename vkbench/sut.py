"""The system under test: vkresample_tpu_torch's batched upscale, as the
folder CLI builds it (vkresample_tpu_torch/cli.py, run_batched).

The only module of the benchmark that imports the port.  The plan takes
the configuration's engine (AUTO: the port's default route) and the card's
own tuning row; no route, engine or dense cap is pinned here.
"""
from __future__ import annotations


def build(config: dict, device):
    """(fn, fmt): fn maps an (N, h, w, C) uint8 batch on `device` to the
    port's output, the parity planes of layout fmt ('quad', 'rows',
    'grid'), or the planar (N, C, H, W) image when fmt is None."""
    from vkresample_tpu_torch.core.config import Engine, Precision
    from vkresample_tpu_torch.core.plan import UpscalePlan
    from vkresample_tpu_torch.core.tuning import plan_for
    from vkresample_tpu_torch.pipeline.batched import build_batched_upscale
    from vkresample_tpu_torch.pipeline.upscale import planes_format

    plan = UpscalePlan(
        h=config["h"], w=config["w"], upscale=config["upscale"],
        precision=Precision[config["precision"]], sharpen=config["sharpen"],
        r2c=config["r2c"], channels=config["channels"], engine=Engine[config["engine"]])
    fmt = planes_format(plan_for(plan, device))
    fn = build_batched_upscale(plan, device, planar_out=True, planes_out=fmt is not None)
    return fn, fmt


def last_build() -> dict:
    """Whether this process compiled the port's kernels, and in how many
    seconds (vkresample_tpu_torch/_build.py)."""
    from vkresample_tpu_torch import _build

    return dict(_build.last_build)
