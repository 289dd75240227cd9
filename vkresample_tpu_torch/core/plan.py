"""Upscale plan: all static geometry derived from (h, w, upscale, precision).

Counterpart of vkresample_tpu/core/plan.py, field for field.  Zero-band
arithmetic matches the reference bit for bit, including its use of *float*
upscale in integer band math (VkResample.cpp:1491-1502): the C code
computes e.g. ``(2*u - 1) * H / (2*u)`` in fp32 and truncates to uint32,
emulated here with explicit float32 steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import Engine, Precision
from .smooth import is_7smooth

# largest axis length the dense engine builds a DFT matrix for
# (vkresample_tpu/fft/mxu_pipeline.py DENSE_MAX).  Every route decision reads
# it here, at call time, through UpscalePlan.above_dense_cap, so a test may
# lower it on this one module to run the big tiers at small shapes.  A card
# with a row in core/tuning.py sets its own cap on the plan families its
# sweep times (UpscalePlan.dense_max).
DENSE_MAX = 8192


def output_dims(h: int, w: int, upscale: float) -> Tuple[int, int]:
    """(H, W) = truncated float products, as the reference's uint32 casts
    (VkResample.cpp:1417-1418, 1363)."""
    u = np.float32(upscale)
    return int(np.float32(h) * u), int(np.float32(w) * u)


def _band_float(n_big: int, upscale: float) -> Tuple[int, int]:
    """Zero band [left, right) computed with C float semantics.

    left  = (uint32)(N / (2*u))                 (VkResample.cpp:1494/1500)
    right = (uint32)((2*u - 1) * N / (2*u))     (VkResample.cpp:1495/1501)
    """
    u = np.float32(upscale)
    two_u = np.float32(2.0) * u
    left = int(np.float32(n_big) / two_u)
    right = int((two_u - np.float32(1.0)) * np.float32(n_big) / two_u)
    return left, right


@dataclasses.dataclass(frozen=True)
class UpscalePlan:
    """Static geometry of one upscale pipeline instance."""

    h: int
    w: int
    upscale: float
    precision: Precision = Precision.SINGLE
    sharpen: float = 0.2
    r2c: bool = True
    channels: int = 3
    engine: Engine = Engine.AUTO
    # the dense cap of the card the plan is built for (core/tuning.py; the
    # entry points fill it from the card's row), None: DENSE_MAX.  It moves
    # only the plan families the card's sweep times
    # (fft/mxu_pipeline.py::card_cap_applies, above_cap)
    dense_max: Optional[int] = None
    # the tier that card runs below its cap, filled with dense_max by
    # core/tuning.py::with_row alone (not a constructor argument): "fft"
    # takes r2c u=2 plans to the cuFFT form (fft/mxu_pipeline.py::
    # fft_tier_selected); "gemm": the dense GEMM tier
    dense_tier: str = dataclasses.field(default="gemm", init=False)

    # --- derived (filled by __post_init__) ---
    H: int = dataclasses.field(init=False)
    W: int = dataclasses.field(init=False)
    # y: zero rows [y_left, y_right)
    y_left: int = dataclasses.field(init=False)
    y_right: int = dataclasses.field(init=False)
    # x: zero cols [x_left, x_right)
    x_left: int = dataclasses.field(init=False)
    x_right: int = dataclasses.field(init=False)
    # exact integer factor if the phase-decomposed inverse applies
    integer_upscale: Optional[int] = dataclasses.field(init=False)

    def __post_init__(self):
        H, W = output_dims(self.h, self.w, self.upscale)
        object.__setattr__(self, "H", H)
        object.__setattr__(self, "W", W)

        y_left, y_right = _band_float(H, self.upscale)
        object.__setattr__(self, "y_left", y_left)
        object.__setattr__(self, "y_right", y_right)

        # x band: left edge is integer w/2 in both modes (VkResample.cpp:1492/1498)
        x_left = self.w // 2
        if self.r2c:
            x_right = W // 2  # (VkResample.cpp:1493)
        else:
            _, x_right = _band_float(W, self.upscale)  # (VkResample.cpp:1499)
        object.__setattr__(self, "x_left", x_left)
        object.__setattr__(self, "x_right", x_right)

        self._validate()

        iu: Optional[int] = None
        u_int = int(round(self.upscale))
        if (
            abs(self.upscale - u_int) < 1e-9
            and u_int >= 1
            and H == u_int * self.h
            and W == u_int * self.w
            and y_left == self.h // 2
            and y_right == H - (self.h - self.h // 2)
            and (not self.r2c or x_right == W // 2)
        ):
            iu = u_int
        object.__setattr__(self, "integer_upscale", iu)

    # ------------------------------------------------------------------
    def _validate(self):
        if self.upscale < 1.0:
            raise ValueError(f"upscale must be >= 1.0, got {self.upscale}")
        if self.precision not in tuple(Precision):
            raise ValueError(f"bad precision {self.precision}")
        # The forward FFT writes spectrum rows [0, h) and the shift pass
        # writes rows [H - h//2, H) (VkResample.cpp:521-525); the inverse
        # reads rows [y_right, H).  A row in [y_right, H) in neither written
        # range means the reference reads uninitialized device memory:
        # reject such geometries.  (At u=1, H == h, any odd height is fine.)
        moved_lo = self.H - self.h // 2
        if max(self.y_right, self.h) < moved_lo:
            raise ValueError(
                f"unsupported geometry: inverse zero band ends at row "
                f"{self.y_right} but relocated spectrum starts at {moved_lo} "
                f"(h={self.h}, upscale={self.upscale}; the reference reads "
                "uninitialized memory here)"
            )
        # kept high rows must come from the relocated block OR (H == h) the
        # identity block
        if self.H > self.h and self.y_right < moved_lo:
            raise ValueError(
                f"unsupported geometry: kept high rows [{self.y_right}, "
                f"{moved_lo}) mix unshifted and shifted spectrum "
                f"(h={self.h}, upscale={self.upscale})"
            )
        if self.y_left > self.h - self.h // 2:
            raise ValueError(
                f"unsupported geometry: kept low rows {self.y_left} exceed "
                f"source spectrum half {self.h - self.h // 2}"
            )
        if not self.r2c:
            moved_lo_x = self.W - self.w // 2
            if self.x_right < moved_lo_x:
                raise ValueError(
                    f"unsupported geometry on x: band right {self.x_right} < "
                    f"relocated start {moved_lo_x}"
                )

    # ------------------------------------------------------------------
    @property
    def kept_lo_y(self) -> int:
        """Spectrum rows [0, kept_lo_y) pass through unshifted."""
        return self.y_left

    @property
    def kept_hi_y(self) -> int:
        """Count of negative-frequency rows kept at the top of the big
        spectrum: G[H - kept_hi_y :] = F[h - kept_hi_y :]."""
        return self.H - self.y_right

    @property
    def kept_lo_x(self) -> int:
        return self.x_left

    @property
    def kept_hi_x(self) -> int:
        """High-side kept columns: c2c relocated columns; r2c identity-
        position columns above the zero band (nonzero only at u == 1,
        where the source Nyquist column survives)."""
        if self.r2c:
            return max(0, self.w // 2 + 1 - self.x_right)
        return self.W - self.x_right

    @property
    def above_dense_cap(self) -> bool:
        """True when some axis, input or output, passes DENSE_MAX (read at
        call time): the plan is in the big tiers."""
        return max(self.h, self.w, self.H, self.W) > DENSE_MAX

    @property
    def mxu_mode(self) -> Optional[str]:
        """How the dense-GEMM tier would execute this plan: 'dense' (every
        axis <= DENSE_MAX), 'phases' (larger, integer factor), 'big'
        (larger, fractional factor) or None (not executable: large
        non-7-smooth dims or odd sizes the row-pair packing rejects)."""
        if not self.above_dense_cap:
            return "dense"
        smooth = (
            is_7smooth(self.h)
            and is_7smooth(self.w)
            and is_7smooth(self.H)
            and is_7smooth(self.W)
        )
        if not smooth:
            return None
        if (
            self.integer_upscale is not None
            and self.h % 2 == 0
            and self.w % 2 == 0
        ):
            return "phases"
        if self.r2c:
            if self.h % 2 == 0 and self.H % 2 == 0 and self.W % 2 == 0:
                return "big"
            return None
        return "big"

    @property
    def mxu_supported(self) -> bool:
        return self.mxu_mode is not None

    def resolve_engine(self) -> Engine:
        if self.engine is Engine.AUTO:
            return Engine.MXU if self.mxu_supported else Engine.XLA
        if self.engine is Engine.MXU and not self.mxu_supported:
            raise ValueError(
                f"MXU engine requires 7-smooth sizes; got "
                f"{self.h}x{self.w} -> {self.H}x{self.W}"
            )
        return self.engine

    def validate_7smooth(self):
        """Reference-parity size check: output dims must be 7-smooth
        (vkFFT.h:4719-4726, help text VkResample.cpp:1813)."""
        for n, name in ((self.H, "output height"), (self.W, "output width")):
            if not is_7smooth(n):
                raise ValueError(
                    f"{name} {n} is not decomposable into primes 2/3/5/7; "
                    "choose an upscale factor giving 7-smooth output dims"
                )
