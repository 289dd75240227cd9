"""vkresample_tpu_torch — PyTorch/CUDA port of vkresample-tpu for NVIDIA
Hopper (H100).

The JAX package ``vkresample_tpu`` stays beside it as the reference.  This
package imports torch and numpy only, never jax or vkresample_tpu, and
builds its CUDA kernels (csrc/) with nvcc at first launch, never at import.

Ported: the R2C and c2c upscale with CAS sharpen in fp32 (-p 0), half
storage (-p 2) and fp64 (-p 1) for every factor (integer and fractional)
at any size, on the GEMM engine (below the 8192 dense cap: R2C quad and
rows parity routes at u=2, the rows route at integer u >= 3, the dense
chain otherwise; c2c: the staged grid at p <= 4 phases, the dense c2c
chain otherwise; above it the staged circulant forms: the R2C u=2 quad,
the R2C grid at u >= 3 and p/q, the c2c grid) and on the torch.fft
reference tier (-engine xla), one frame or a batch of frames a call, and
the batched-folder CLI mode (-ifolder -ofolder -numfiles -numthreads
-batch -resume) with its PNG worker pool.  Staged bank sets are cached on
disk (core/bankcache.py).  Beside the upscaler, the VkFFT engine surface:
circular, K-kernel, matrix and linear convolution in the frequency domain
(ops/convolve.py) and the N-D FFT over (re, im) pairs (fft/ndim.py), on
torch.fft.  Over several devices: a frame batch splits evenly over a
list of devices ("dp", parallel/mesh.py), and one frame splits over the
ranks of a torch.distributed group in the "sp" pencil mode
(parallel/distributed.py; parallel/launch.py starts the ranks).  The entry
points run on the current CUDA device unless the caller passes
device="cpu".  Where the dense and the staged tiers cross is the card's
(core/tuning.py, a table keyed on the card's name); graft_entry.py holds
entry() and dryrun_multichip(), the counterparts of the root
__graft_entry__.py.

Public API:
    upscale(img, upscale, precision=..., sharpen=..., r2c=..., engine=..., device=...) -> (H, W, C) uint8
    build_upscale(plan, device, planes_out=..., planar_out=...) -> per-frame function
    upscale_batch(imgs, plan, device=...) -> (N, H, W, C) uint8
    build_batched_upscale(plan, device, planar_out=..., planes_out=...) -> per-batch function
    UpscalePlan, Precision, Engine, ResampleConfig, output_dims
    factorize_7smooth, is_7smooth, plan_factors — 7-smooth size planning
    fft_convolve2d(x, kernel, engine=..., device=...) -> circular convolution
    fft_matrix_convolve2d(x, kernel, engine=..., device=...) -> matrix convolution
    build_sp_upscale, build_sp_upscale_dense, build_sp_upscale_staged,
    build_sp_upscale_grid, build_sp_upscale_c2c_grid (plan, group, device)
        -> this rank's function of one frame's row block
"""

__version__ = "0.1.0"

from .core.config import Engine, Precision, ResampleConfig  # noqa: F401
from .core.plan import UpscalePlan, output_dims  # noqa: F401
from .core.smooth import factorize_7smooth, is_7smooth, plan_factors  # noqa: F401
from .ops.convolve import fft_convolve2d, fft_matrix_convolve2d  # noqa: F401
from .pipeline.batched import build_batched_upscale, upscale_batch  # noqa: F401
from .pipeline.upscale import build_upscale, upscale  # noqa: F401
from .parallel.distributed import (  # noqa: F401
    build_sp_upscale,
    build_sp_upscale_c2c_grid,
    build_sp_upscale_dense,
    build_sp_upscale_grid,
    build_sp_upscale_staged,
)
