// Fused row weave + woven CAS + quantize for the integer u >= 3 rows route
// (Hopper, sm_90a).
//
// Replaces the Pallas kernel family behind
// vkresample_tpu/ops/cas_pallas.py::cas_quantize_rows_u (kernel bodies
// _rows_kernel and _rows_slots_kernel; stencil math _cas_band).
//
// What it computes.  The row-split transform hands over the sample output
// rows U (C, h, W) and the non-sample rows O (C, h*(u-1), W), both int16
// Q2.14 (x 1/16384) or both float32, with O[t*(u-1) + k] = out[u*t + k + 1].
// They are the woven image V[c, u*t] = U[c, t], V[c, u*t + k + 1] =
// O[c, t*(u-1) + k] of size (C, u*h, W).  Every output pixel is the 3x3
// clamp-to-edge CAS of L = min(|V|, 1) (cas_common.cuh), written to the
// woven uint8 image (C, u*h, W).  The woven pre-CAS image never exists in
// device memory: the route's two passes, a row weave then the woven CAS
// (cas_woven.cu), become one.
//
// Bound on this card.  About 40 flops per output pixel against 2-4 bytes
// read and 1 written: device memory bounds it.  At 1280x720 -> 3840x2160
// (u=3) it reads U + O once, 49.8 MB of int16 (99.5 MB of float32), and
// writes 24.9 MB of uint8: ~22.3 us (int16) at the 3.35 TB/s peak, the
// woven CAS's bound without the woven image's write and re-read.
//
// Design.  cas_woven.cu's tile, fed from the two row-split arrays: a block
// covers 32 columns x 16 woven rows (two per thread) and first stages the
// (16+2) x (32+2) window of L values in shared memory.  A window row's woven
// index Y is clamped to [0, u*h-1] before it is split into (t, k) = (Y / u,
// Y % u), which reads U[t] for k == 0 and O[t*(u-1) + k-1] otherwise; the
// split runs once per window row (18 threads fill a table of row pointers),
// not once per element, so the divide by a run-time u stays off the
// staging loop.  Columns clamp to [0, W-1].  The tile then holds exactly
// the values the woven CAS would stage from the woven image, and the CAS is
// the same cas_at, so the output equals weave + woven CAS on every pixel, for any
// u >= 2 and any h, W >= 1.  The TPU kernel's band/slot DMA schedules and
// its W % 128 weave fallback have no counterpart here.
#include "cas_common.cuh"

namespace {

constexpr int kTX = 32;             // columns per block (one per thread)
constexpr int kTY = 8;              // thread rows per block
constexpr int kRows = 2;            // output rows per thread
constexpr int kTH = kTY * kRows;    // woven rows per block
constexpr int kSW = kTX + 2;        // tile width incl. halo
constexpr int kSH = kTH + 2;        // tile height incl. halo

template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
cas_rows_kernel(const T* __restrict__ U, const T* __restrict__ O,
                uint8_t* __restrict__ out, int h, int W, int u, float sharpen) {
  __shared__ float tile[kSH][kSW];
  __shared__ const T* rows[kSH];  // the U or O row behind each tile row
  const int H = u * h;
  const size_t c = blockIdx.z;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTX;

  if (threadIdx.y == 0 && threadIdx.x < kSH) {
    const int Y = min(max(y0 - 1 + (int)threadIdx.x, 0), H - 1);
    const int t = Y / u, k = Y - t * u;
    rows[threadIdx.x] = k == 0 ? U + (c * h + t) * (size_t)W
                               : O + ((c * h + t) * (u - 1) + (k - 1)) * (size_t)W;
  }
  __syncthreads();
  for (int i = threadIdx.y * kTX + threadIdx.x; i < kSH * kSW; i += kTX * kTY) {
    const int r = i / kSW, q = i - r * kSW;
    tile[r][q] = clip_len(rows[r][min(max(x0 - 1 + q, 0), W - 1)]);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  uint8_t* oc = out + c * (size_t)H * (size_t)W;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int ty = threadIdx.y + k * kTY;
    const int y = y0 + ty;
    if (y < H) {
      oc[(size_t)y * W + x] = cas_at<kSW>(tile, ty + 1, threadIdx.x + 1, sharpen);
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes).  U: contiguous (C, h, W), O:
// contiguous (C, h*(u-1), W), one dtype (is_i16: int16 Q2.14, else
// float32); out: contiguous (C, u*h, W) uint8.  Launches on `stream`, does
// not synchronise, returns the cudaError_t of the launch.
extern "C" int vkr_cas_rows_u(const void* U, const void* O, void* out, int C,
                              int h, int W, int u, int is_i16, float sharpen,
                              void* stream) {
  if (C <= 0 || h <= 0 || W <= 0 || u < 2) return (int)cudaErrorInvalidValue;
  if ((long long)u * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (u * h + kTH - 1) / kTH, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_i16) {
    cas_rows_kernel<int16_t><<<grid, block, 0, st>>>(
        static_cast<const int16_t*>(U), static_cast<const int16_t*>(O), o, h, W, u, sharpen);
  } else {
    cas_rows_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(U), static_cast<const float*>(O), o, h, W, u, sharpen);
  }
  return (int)cudaGetLastError();
}
