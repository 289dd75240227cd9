"""Per-card tuning table (counterpart of vkresample_tpu/core/tuning.py).

The reference keys a small tuning table off the GPU vendor ID (coalesced
memory width, warp size, 4-step swap; VkResample.cpp:1371-1408).  The JAX
package keys its table off the TPU's device_kind.  This one keys off the
card's name, torch.cuda.get_device_name, matched by substring as JAX
matches device_kind.

DeviceTuning holds what the port reads at run time: dense_max, the largest
axis at which a plan runs the dense GEMM tier (fft/dense.py) rather than
the staged circulant tier (fft/staged.py).  The default is
core/plan.py::DENSE_MAX (8192, JAX's value), read when the default row is
made, so a test that lowers DENSE_MAX lowers the default too.

The JAX table's other eleven fields are left out.  They are Pallas band
heights and strip widths: rows_block, cas_block_rows, parity_block,
quad_wsb, quad_wmax, quad_block, quad_strip_block, quad_fw_slots_block and
grid_block (read at vkresample_tpu/ops/cas_pallas.py:488, 558, 793,
1586-1588, 1620, 1656, 1681, 1688, 1790, 2225, 2277-2279) and ycas_wb and
ycas_bo (ops/ycas_pallas.py:428-430, 533-535).  The port's kernels (csrc/)
fix their tiles at compile time, so no code of the port could read them.
No JAX module reads dense_max either: its cap is the constant
fft/mxu_pipeline.py DENSE_MAX.

How the port reads a row's dense_max: the entry points (build_upscale,
upscale, build_batched_upscale and each share of a "dp" list, the CLI)
resolve the device and give the plan that card's cap (plan_for, which
fills UpscalePlan.dense_max), and the route functions of
fft/mxu_pipeline.py and pipeline/upscale.py read it from the plan.  The
card's cap moves only the plan families the sweep below times on both
tiers (mxu_pipeline.card_cap_applies: r2c u=2 on the staged quad, r2c u=3
and 3/2 on the r2c grid, at -p 0 and -p 2); every other plan keeps its
route up to DENSE_MAX, the largest DFT matrix the dense tier builds, so a
lower cap takes away no plan that runs and moves none it did not time.  The sp functions (parallel/distributed.py)
run the pencil form their caller names, so no cap applies to them.

The H100 row comes from scripts/torch_dense_cap_sweep.py, which times the
dense and the staged tier of the same plans on the card; PERF.md holds
its readings.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import plan as plan_mod
from .plan import UpscalePlan


@dataclasses.dataclass(frozen=True)
class DeviceTuning:
    # largest axis at which a plan of the swept families
    # (mxu_pipeline.card_cap_applies) runs on the dense tier
    dense_max: int = dataclasses.field(default_factory=lambda: plan_mod.DENSE_MAX)


_TABLE = {
    # torch.cuda.get_device_name substring -> tuning.  H100 SXM (700 W),
    # scripts/torch_dense_cap_sweep.py, two runs in one call (PERF.md
    # section 6): past 4608 every swept plan ran faster on the staged
    # tier, in both modes; at 4608 u=3 ran faster dense and the u=2 quad and
    # 1.5x -p 2 tied; at 3840-4096 the staged tier lost or tied (dense
    # faster at u=3 and 1.5x 3840).  The PCIe and NVL parts were not
    # measured: they keep the default.
    "H100 80GB HBM3": DeviceTuning(dense_max=4608),
}


@functools.lru_cache(maxsize=None)
def row_for_name(name: str) -> Optional[DeviceTuning]:
    """The table row whose key is a substring of the card's name, None when
    no row matches."""
    for key, row in _TABLE.items():
        if key in name:
            return row
    return None


def _row(device) -> Optional[DeviceTuning]:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return row_for_name(torch.cuda.get_device_name(device))


def current(device) -> DeviceTuning:
    """The tuning of `device` (a torch device or its name): its card's row,
    else the default (the CPU's too)."""
    return _row(device) or DeviceTuning()


def plan_for(plan: UpscalePlan, device) -> UpscalePlan:
    """The plan with the dense cap of `device`'s row, for the route
    functions to read; the plan as it is when it has a cap already (a
    caller's choice) or the card has no row."""
    if plan.dense_max is not None:
        return plan
    row = _row(device)
    return plan if row is None else dataclasses.replace(plan, dense_max=row.dense_max)
