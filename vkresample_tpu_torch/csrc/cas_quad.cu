// Quad-parity fused CAS + quantize for the u=2 upscale route (Hopper, sm_90a).
//
// Replaces the Pallas kernel family behind
// vkresample_tpu/ops/cas_pallas.py::cas_parity4_planes_u2 (kernel bodies
// _quad_kernel, _quad_strip_kernel, _quad_strip_slots_kernel; stencil math
// _quad_planes, _cas_core, _cas_blend).
//
// What it computes.  The transform hands over four pre-CAS parity planes
// P[ry][rx], each (C, h, Wh), int16 Q2.14 (x 1/16384) or float32.  They are
// the woven image V[c, 2t+ry, 2s+rx] = P[ry][rx][c, t, s] of size
// (C, 2h, 2Wh).  With L = min(|V|, 1), every output pixel is the 3x3
// clamp-to-edge FidelityFX-CAS of L (VkResample.cpp:887-923): two-level
// min/max over cross and corners, scale = -s * num * rsqrt(max(num*den,
// 1e-30)), out = (c + scale*(n+s+w+e)) / (1 + 4*scale), then
// (int)clamp(out*255, 0, 255).  The result is written back as four uint8
// parity planes, so the woven image exists neither in device memory nor on
// the host (the PNG encoder weaves the planes in its row loop).
//
// Bound on this card.  About 30 flops per output pixel against 2-4 bytes
// read and 1 written: far below the H100's ~20 flops/byte ridge in fp32, so
// the kernel is bound by device memory.  At the flagship 2048x1024 ->
// 4096x2048 shape it reads 4 x 3 x 1024 x 2048 x 2 B = 50 MB of int16
// (100 MB in float32) and writes 25 MB of uint8: ~23 us (int16) at the
// 3.35 TB/s peak.
//
// Design.  One thread per plane position (c, t, s) computes all four output
// parities there.  A block covers 32 x 8 positions; it first stages the
// woven (2*8+2) x (2*32+2) window of L values (the tile plus a one-pixel
// woven halo) in shared memory, mapping woven (Y, X) to plane (Y&1, X&1) at
// (Y>>1, X>>1) after clamping Y to [0, 2h-1] and X to [0, 2Wh-1]
// independently, which is exactly the reference's id_x_m / id_y_m edge
// clamp.  Every global load is clamped, so any h >= 1 and Wh >= 1 works:
// the TPU kernel's replicate-pad reroute, woven fallback and band/strip/slot
// DMA variants have no counterpart here.  Each input element is read from
// device memory ~1.2 times (halo), each output written once.  The blend is
// written with explicit round-to-nearest intrinsics (no FMA contraction) so
// it rounds like the plain PyTorch version op for op (cas_common.cuh).
#include "cas_common.cuh"

namespace {

constexpr int kTX = 32;             // plane columns per block
constexpr int kTY = 8;              // plane rows per block
constexpr int kSW = 2 * kTX + 2;    // woven tile width incl. halo
constexpr int kSH = 2 * kTY + 2;    // woven tile height incl. halo

template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
cas_quad_kernel(const T* __restrict__ p00, const T* __restrict__ p01,
                const T* __restrict__ p10, const T* __restrict__ p11,
                uint8_t* __restrict__ o00, uint8_t* __restrict__ o01,
                uint8_t* __restrict__ o10, uint8_t* __restrict__ o11,
                int h, int Wh, float sharpen) {
  __shared__ float tile[kSH][kSW];
  const size_t plane = (size_t)h * (size_t)Wh;
  const size_t cbase = (size_t)blockIdx.z * plane;
  const int t0 = blockIdx.y * kTY;
  const int s0 = blockIdx.x * kTX;
  const int ymax = 2 * h - 1, xmax = 2 * Wh - 1;

  for (int i = threadIdx.y * kTX + threadIdx.x; i < kSH * kSW; i += kTX * kTY) {
    const int r = i / kSW, q = i - r * kSW;
    const int Y = min(max(2 * t0 - 1 + r, 0), ymax);
    const int X = min(max(2 * s0 - 1 + q, 0), xmax);
    const T* src = (Y & 1) ? ((X & 1) ? p11 : p10) : ((X & 1) ? p01 : p00);
    tile[r][q] = clip_len(src[cbase + (size_t)(Y >> 1) * Wh + (X >> 1)]);
  }
  __syncthreads();

  const int t = t0 + threadIdx.y, s = s0 + threadIdx.x;
  if (t >= h || s >= Wh) return;
  const size_t o = cbase + (size_t)t * Wh + s;
  uint8_t* dst[2][2] = {{o00, o01}, {o10, o11}};
#pragma unroll
  for (int ry = 0; ry < 2; ++ry) {
#pragma unroll
    for (int rx = 0; rx < 2; ++rx) {
      const int r = 2 * threadIdx.y + ry + 1, q = 2 * threadIdx.x + rx + 1;
      dst[ry][rx][o] = cas_at<kSW>(tile, r, q, sharpen);
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes).  p*: four contiguous (C, h, Wh)
// planes of one dtype (is_i16: int16 Q2.14, else float32); o*: four
// contiguous (C, h, Wh) uint8 outputs.  Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int vkr_cas_quad_u2(const void* p00, const void* p01,
                               const void* p10, const void* p11,
                               void* o00, void* o01, void* o10, void* o11,
                               int C, int h, int Wh, int is_i16,
                               float sharpen, void* stream) {
  if (C <= 0 || h <= 0 || Wh <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid((Wh + kTX - 1) / kTX, (h + kTY - 1) / kTY, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* u00 = static_cast<uint8_t*>(o00);
  uint8_t* u01 = static_cast<uint8_t*>(o01);
  uint8_t* u10 = static_cast<uint8_t*>(o10);
  uint8_t* u11 = static_cast<uint8_t*>(o11);
  if (is_i16) {
    cas_quad_kernel<int16_t><<<grid, block, 0, st>>>(
        static_cast<const int16_t*>(p00), static_cast<const int16_t*>(p01),
        static_cast<const int16_t*>(p10), static_cast<const int16_t*>(p11),
        u00, u01, u10, u11, h, Wh, sharpen);
  } else {
    cas_quad_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(p00), static_cast<const float*>(p01),
        static_cast<const float*>(p10), static_cast<const float*>(p11),
        u00, u01, u10, u11, h, Wh, sharpen);
  }
  return (int)cudaGetLastError();
}
