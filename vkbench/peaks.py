"""Published peaks of the cards the benchmark runs on, keyed by a
substring of torch.cuda.get_device_name.

H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit): 3.35 TB/s
of HBM3, 67 TFLOP/s of float32 outside the tensor cores.  A card set
below 700 W runs slower under load: the traced run prints its power limit
beside every share of a peak.
"""
from __future__ import annotations

import subprocess
from typing import Optional

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}


def peaks_for(card: str) -> Optional[dict]:
    for key, row in PEAKS.items():
        if key in card:
            return row
    return None


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not read (nvidia-smi exit {out.returncode})"
