// Woven CAS + quantize for the generic upscale routes (Hopper, sm_90a).
//
// Replaces the Pallas kernel family behind
// vkresample_tpu/ops/cas_pallas.py::cas_quantize_pallas (kernel bodies
// _cas_kernel and _cas_slots_kernel; stencil math _cas_band).
//
// What it computes.  A pre-CAS image v (C, H, W), int16 Q2.14 (x 1/16384)
// or float32, already in CAS units (the u^2 pre-scale folded in), goes to
// the uint8 image (C, H, W): the 3x3 clamp-to-edge CAS of L = min(|v|, 1)
// followed by (int)clamp(out*255, 0, 255) (cas_common.cuh).  It serves
// every route whose transform emits a woven image: integer u >= 3 (rows
// route + row weave), the dense chain (fractional factors and u = 1) and
// the reference tier (-engine xla).
//
// Bound on this card.  About 30 flops per output pixel against 2-4 bytes
// read and 1 written: far below the H100's ~20 flops/byte ridge in fp32,
// so the kernel is bound by device memory.  At (3, 2160, 3840) (1280x720
// -> 3840x2160) it reads 99.5 MB of float32 (49.8 MB of int16) and writes
// 24.9 MB of uint8: ~37 us (f32) at the 3.35 TB/s peak.
//
// Design.  One thread per output column of a block's tile, kRows rows per
// thread.  A block covers 32 columns x 16 rows; it first stages the
// (16+2) x (32+2) window of L values (the tile plus a one-pixel halo) in
// shared memory, clamping rows to [0, H-1] and columns to [0, W-1]
// independently -- exactly the reference's id_x_m / id_y_m edge clamp.
// Every global load is clamped, so any H >= 1 and W >= 1 works: the TPU
// kernel's W % 128 / band-fit XLA fallback and its halo/slot DMA variants
// have no counterpart here.  Each input element is read from device memory
// ~1.2 times (halo), each output written once.
#include "cas_common.cuh"

namespace {

constexpr int kTX = 32;             // columns per block (one per thread)
constexpr int kTY = 8;              // thread rows per block
constexpr int kRows = 2;            // output rows per thread
constexpr int kTH = kTY * kRows;    // rows per block
constexpr int kSW = kTX + 2;        // tile width incl. halo
constexpr int kSH = kTH + 2;        // tile height incl. halo

template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
cas_woven_kernel(const T* __restrict__ v, uint8_t* __restrict__ out,
                 int H, int W, float sharpen) {
  __shared__ float tile[kSH][kSW];
  const size_t cbase = (size_t)blockIdx.z * (size_t)H * (size_t)W;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTX;

  for (int i = threadIdx.y * kTX + threadIdx.x; i < kSH * kSW; i += kTX * kTY) {
    const int r = i / kSW, q = i - r * kSW;
    const int Y = min(max(y0 - 1 + r, 0), H - 1);
    const int X = min(max(x0 - 1 + q, 0), W - 1);
    tile[r][q] = clip_len(v[cbase + (size_t)Y * W + X]);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int ty = threadIdx.y + k * kTY;
    const int y = y0 + ty;
    if (y < H) {
      out[cbase + (size_t)y * W + x] = cas_at<kSW>(tile, ty + 1, threadIdx.x + 1, sharpen);
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes).  v: contiguous (C, H, W) of one dtype
// (is_i16: int16 Q2.14, else float32); out: contiguous (C, H, W) uint8.
// Launches on `stream`, does not synchronise, returns the cudaError_t of
// the launch.
extern "C" int vkr_cas_woven(const void* v, void* out, int C, int H, int W,
                             int is_i16, float sharpen, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTH - 1) / kTH, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_i16) {
    cas_woven_kernel<int16_t><<<grid, block, 0, st>>>(
        static_cast<const int16_t*>(v), o, H, W, sharpen);
  } else {
    cas_woven_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(v), o, H, W, sharpen);
  }
  return (int)cudaGetLastError();
}
