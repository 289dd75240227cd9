// Copy-quantize probes: the woven CAS kernels' data movement with the CAS
// arithmetic taken out (Hopper, sm_90a).
//
// Replaces scripts/cas_split.py::copy_quantize (kernel body _copy_kernel:
// cas_quantize_pallas's bands of bh rows plus halo rows, double-buffered
// manual DMA, with the CAS swapped for a plain quantize).  The script times
// it beside the full CAS kernel to split the CAS's cost into data movement
// and arithmetic; this file does the same for the two data-movement designs
// of the port's woven CAS kernels, one entry point each:
//
//   vkr_copy_quantize_tile  (K10a) the grid, block and shared tile of K3's
//                           first design (a 32 x 16 float tile, retired
//                           when K3 moved onto cas_rows.cu's kernel), the
//                           tile centre quantized where that K3 evaluated
//                           the CAS; it stages the raw values.  It stays
//                           as the probe of that data movement.
//   vkr_copy_quantize_mono  (K10b) cas_mono.cu's (K7's) persistent cp.async
//                           band pipeline (band_pipeline.cuh), each lane's
//                           centre float4 quantized where K7 evaluates the
//                           CAS
//
// What it computes.  A float32 image v (C, H, W) goes to the uint8 image
// (C, H, W): out = (int)clamp(v * 255, 0, 255) (cas_common.cuh::
// quantize_u8; ops/cas.py::quantize_u8).  Every H, W, bh >= 1 runs and the
// output does not depend on bh: the TPU kernel's limits (H a multiple of
// bh, H >= bh + 16, 8-aligned window starts) are not carried over.
//
// Bound on this card.  One multiply, two clamps and a convert per pixel
// against 4 bytes read and 1 written: device memory bounds it.  At (3,
// 2048, 4096) it reads 100.7 MB and writes 25.2 MB: ~37.6 us at the 3.35
// TB/s peak.  Both forms move what their CAS kernel moves (K10a: K3's
// first design), halo included (K10a ~1.2 reads of each input element,
// K10b (R+2)/R row reads), so the gap between that CAS kernel's time and
// its form's time is the CAS arithmetic.
#include "band_pipeline.cuh"
#include "cas_common.cuh"

namespace {

// K3's first tile: 32 x 8 threads, 2 rows each, an 18 x 34 tile.
constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kRows = 2;
constexpr int kTH = kTY * kRows;
constexpr int kSW = kTX + 2;
constexpr int kSH = kTH + 2;

__global__ void __launch_bounds__(kTX * kTY)
copy_quantize_tile_kernel(const float* __restrict__ v, uint8_t* __restrict__ out, int H, int W) {
  __shared__ float tile[kSH][kSW];
  const size_t cbase = (size_t)blockIdx.z * (size_t)H * (size_t)W;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTX;

  for (int i = threadIdx.y * kTX + threadIdx.x; i < kSH * kSW; i += kTX * kTY) {
    const int r = i / kSW, q = i - r * kSW;
    const int Y = min(max(y0 - 1 + r, 0), H - 1);
    const int X = min(max(x0 - 1 + q, 0), W - 1);
    tile[r][q] = v[cbase + (size_t)Y * W + X];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int ty = threadIdx.y + k * kTY;
    const int y = y0 + ty;
    if (y < H) {
      out[cbase + (size_t)y * W + x] = quantize_u8(tile[ty + 1][threadIdx.x + 1]);
    }
  }
}

// K7's band pipeline with the quantize of the lane's four centre values.
struct QuantizeRows {
  __device__ __forceinline__ void start(const float*, int, int) {}

  __device__ __forceinline__ void row(const float* win, int j, int lane, uint8_t (&o)[4]) {
    const float4 m = *reinterpret_cast<const float4*>(
        win + (j + 1) * band::kPitch + band::kLeft + 4 * lane);
    o[0] = quantize_u8(m.x);
    o[1] = quantize_u8(m.y);
    o[2] = quantize_u8(m.z);
    o[3] = quantize_u8(m.w);
  }
};

}  // namespace

// C entry points (loaded with ctypes).  v: contiguous (C, H, W) float32;
// out: contiguous (C, H, W) uint8; bh (mono): rows per band, capped at H
// and 192.  Launch on `stream`, do not synchronise, return the first
// cudaError_t of the set-up calls and the launch.
extern "C" int vkr_copy_quantize_tile(const void* v, void* out, int C, int H, int W,
                                      void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTH - 1) / kTH, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  copy_quantize_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<uint8_t*>(out), H, W);
  return (int)cudaGetLastError();
}

extern "C" int vkr_copy_quantize_mono(const void* v, void* out, int C, int H, int W, int bh,
                                      void* stream) {
  return band::launch(v, out, C, H, W, bh, QuantizeRows{}, stream);
}
