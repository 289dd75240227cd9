"""Run configuration (counterpart of vkresample_tpu/core/config.py).

Flag surface and defaults of the reference's ``VkResampleConfiguration``
(VkResample.cpp:45-59, CLI defaults 1797-1804): upscale=1, precision=0,
numIter=1, device_id=0, numThreads=1, sharpen=0.2.

Precision modes (``-p``):
    0 - single:  fp32 storage + compute
    1 - double:  fp64 storage + compute
    2 - half:    half-precision *memory only*: the pre-CAS planes are
        stored as int16 Q2.14 (ops/cas.py), compute stays fp32.

The port runs every float32 GEMM in full fp32 with TF32 off (see
fp32_matmul below); there is no per-mode matmul precision knob.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Optional

import torch


class Precision(enum.IntEnum):
    """Numeric precision mode, flag-compatible with the reference ``-p``."""

    SINGLE = 0
    DOUBLE = 1
    HALF = 2  # memory-only half: int16 Q2.14 storage, fp32 compute

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float64 if self is Precision.DOUBLE else torch.float32

    @property
    def storage_dtype(self) -> torch.dtype:
        """Pre-CAS plane storage dtype: int16 Q2.14 in HALF (same bytes as
        the reference's fp16 storage)."""
        if self is Precision.DOUBLE:
            return torch.float64
        if self is Precision.HALF:
            return torch.int16
        return torch.float32


class Engine(enum.Enum):
    """FFT execution tier, flag-compatible with the JAX package's
    ``-engine``.  MXU is the dense GEMM tier (fft/mxu_pipeline.py), XLA
    the torch.fft reference tier; AUTO resolves to MXU where the plan
    allows it."""

    AUTO = "auto"
    XLA = "xla"
    MXU = "mxu"


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Flag-level run configuration (reference: VkResample.cpp:45-59)."""

    upscale: float = 1.0  # -u
    precision: Precision = Precision.SINGLE  # -p
    num_iter: int = 1  # -n
    device_id: int = 0  # -d
    num_threads: int = 1  # -numthreads
    sharpen: float = 0.2  # -s
    input_path: Optional[str] = None  # -i
    output_path: Optional[str] = None  # -o
    ifolder_prefix: Optional[str] = None  # -ifolder
    ofolder_prefix: Optional[str] = None  # -ofolder
    num_files: int = 1  # -numfiles
    engine: Engine = Engine.AUTO

    @property
    def file_upload(self) -> bool:
        """Batched-folder mode (reference ``fileUpload``)."""
        return self.ifolder_prefix is not None


def resolve_device(device=None) -> torch.device:
    """The device an entry point of the port runs on: the current CUDA
    device unless the caller names one (``"cpu"`` runs the kernels' plain
    versions).  RuntimeError when no device is named and no CUDA device is
    present: the port never falls back to the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on a CUDA GPU; pass device='cpu' "
                "to run its plain CPU versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def fp32_matmul():
    """Run the block with float32 matmuls (and cuDNN convolutions and RNNs)
    in full fp32, then restore the TF32 settings exactly as they were, also
    when the block raises.  torch.set_float32_matmul_precision sets the
    legacy matmul precision and the per-backend matmul fp32_precision
    together; cuDNN goes through its per-backend fp32_precision settings
    where the installed torch has them, else through cudnn.allow_tf32."""
    b = torch.backends
    if hasattr(b.cuda.matmul, "fp32_precision"):
        flags = [(m, "fp32_precision", "ieee") for m in (b.cuda.matmul, b.cudnn.conv, b.cudnn.rnn)]
    else:
        flags = [(b.cudnn, "allow_tf32", False)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in flags]
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    for m, name, value in flags:
        setattr(m, name, value)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        for m, name, value in saved:
            setattr(m, name, value)


def default_output_name(w: int, upscale: float) -> str:
    """Default single-image output name (reference: VkResample.cpp:1706)."""
    return "%d_%d_upscaled.png" % (w, int(upscale * w))
