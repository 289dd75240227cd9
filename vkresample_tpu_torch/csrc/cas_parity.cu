// Rows-parity fused CAS + quantize for the u=2 rows route (Hopper, sm_90a).
//
// Replaces the Pallas kernel behind
// vkresample_tpu/ops/cas_pallas.py::cas_parity_planes_u2 (kernel body
// _parity_kernel; stencil math _parity_planes, _cas_core, _cas_blend).
//
// What it computes.  The u=2 rows transform hands over the sample rows U
// and the odd rows O, each (C, h, W), int16 Q2.14 (x 1/16384) or float32.
// They are the woven image V[c, 2t] = U[c, t], V[c, 2t+1] = O[c, t] of size
// (C, 2h, W).  Every output pixel is the 3x3 clamp-to-edge CAS of
// L = min(|V|, 1) (cas_common.cuh); the result is written back as the even
// rows E and the odd rows D, each (C, h, W) uint8, so the woven pre-CAS
// image never exists in device memory.  Row 2t (centre U[t]) has north
// O[t-1] and south O[t]; row 2t+1 (centre O[t]) has north U[t] and south
// U[t+1]; even row 0 takes itself as north and odd row 2h-1 itself as south,
// and columns clamp to the row's own end values: the separable clamps of
// the reference's id_x_m / id_y_m.
//
// Bound on this card.  About 30 flops per output pixel against 2-4 bytes
// read and 1 written: far below the H100's ~20 flops/byte ridge in fp32,
// so the kernel is bound by device memory.  At (3, 1080, 2880) (1440x1080
// -> 2880x2160) it reads 37.3 MB of int16 (74.6 MB of float32) and writes
// 18.7 MB of uint8: ~17 us (int16) at the 3.35 TB/s peak.
//
// Design.  One thread per plane position (c, t, x) computes both output
// parities there.  A block covers 32 columns x 8 plane rows; it first
// stages the woven (2*8+2) x (32+2) window of L values (the tile plus a
// one-pixel woven halo) in shared memory, mapping woven row Y to U or O by
// Y & 1 at plane row Y >> 1 after clamping Y to [0, 2h-1] and the column to
// [0, W-1] independently.  Every global load is clamped, so any h >= 1 and
// W >= 1 works, including the widths that are not a multiple of 128 this
// route exists for: the TPU kernel's weave + woven-CAS fallback and its
// band DMA schedule have no counterpart here.  Each input element is read
// from device memory ~1.2 times (halo), each output written once.
#include "cas_common.cuh"

namespace {

constexpr int kTX = 32;             // plane columns per block
constexpr int kTY = 8;              // plane rows per block
constexpr int kSW = kTX + 2;        // tile width incl. halo
constexpr int kSH = 2 * kTY + 2;    // woven tile height incl. halo

template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
cas_parity_kernel(const T* __restrict__ U, const T* __restrict__ O,
                  uint8_t* __restrict__ E, uint8_t* __restrict__ D,
                  int h, int W, float sharpen) {
  __shared__ float tile[kSH][kSW];
  const size_t cbase = (size_t)blockIdx.z * (size_t)h * (size_t)W;
  const int t0 = blockIdx.y * kTY;
  const int x0 = blockIdx.x * kTX;
  const int ymax = 2 * h - 1;

  for (int i = threadIdx.y * kTX + threadIdx.x; i < kSH * kSW; i += kTX * kTY) {
    const int r = i / kSW, q = i - r * kSW;
    const int Y = min(max(2 * t0 - 1 + r, 0), ymax);
    const int X = min(max(x0 - 1 + q, 0), W - 1);
    const T* src = (Y & 1) ? O : U;
    tile[r][q] = clip_len(src[cbase + (size_t)(Y >> 1) * W + X]);
  }
  __syncthreads();

  const int t = t0 + threadIdx.y, x = x0 + threadIdx.x;
  if (t >= h || x >= W) return;
  const size_t o = cbase + (size_t)t * W + x;
  const int r = 2 * threadIdx.y + 1, q = threadIdx.x + 1;
  E[o] = cas_at<kSW>(tile, r, q, sharpen);
  D[o] = cas_at<kSW>(tile, r + 1, q, sharpen);
}

}  // namespace

// C entry point (loaded with ctypes).  U, O: contiguous (C, h, W) of one
// dtype (is_i16: int16 Q2.14, else float32); E, D: contiguous (C, h, W)
// uint8 outputs.  Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch.
extern "C" int vkr_cas_parity_u2(const void* U, const void* O, void* E, void* D,
                                 int C, int h, int W, int is_i16,
                                 float sharpen, void* stream) {
  if (C <= 0 || h <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (h + kTY - 1) / kTY, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* e = static_cast<uint8_t*>(E);
  uint8_t* d = static_cast<uint8_t*>(D);
  if (is_i16) {
    cas_parity_kernel<int16_t><<<grid, block, 0, st>>>(
        static_cast<const int16_t*>(U), static_cast<const int16_t*>(O),
        e, d, h, W, sharpen);
  } else {
    cas_parity_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(U), static_cast<const float*>(O),
        e, d, h, W, sharpen);
  }
  return (int)cudaGetLastError();
}
