// Woven CAS + quantize in one persistent launch with an asynchronous,
// double-buffered band pipeline (Hopper, sm_90a).
//
// Replaces vkresample_tpu/ops/cas_pallas.py::cas_quantize_mono (kernel
// body _cas_mono_kernel: one invocation, an in-kernel band loop,
// double-buffered manual DMA in and out; stencil math _cas_band).
//
// What it computes.  A float32 pre-CAS image v (C, H, W) goes to the uint8
// image (C, H, W): the 3x3 clamp-to-edge CAS of L = min(|v|, 1) with the
// rsqrt blend (cas_common.cuh::cas_pixel), then (int)clamp(out*255, 0,
// 255) -- K3's arithmetic, so the output equals cas_woven.cu's on every
// pixel.
//
// Bound on this card.  About 40 flops per output pixel against 4 bytes
// read and 1 written: device memory bounds it.  At (3, 2048, 4096) it reads
// 100.7 MB and writes 25.2 MB: ~37.6 us at the 3.35 TB/s peak.
//
// Design.  The persistent band pipeline of band_pipeline.cuh: work items
// (channel, band of R = min(bh, H, 192) rows, strip of 128 columns) walked
// with a grid stride, two shared-memory windows of (R+2) x (128+8) float32
// filled by cp.async while the other is computed (the write-after-read
// hazard the JAX kernel guards with its output-DMA wait is a __syncthreads
// there).  The body here: each lane walks down its warp's rows with a
// 3-row x 6-column register window of L values (one float4 and two scalar
// shared loads per row) and evaluates cas_pixel for its four columns.
// Every H, W, bh >= 1 runs: the TPU kernel's bh < 32 / W % 128 / H < bh +
// 16 reroute to the woven kernel has no counterpart here.
#include "band_pipeline.cuh"
#include "cas_common.cuh"

namespace {

// The 6 L values of window row r around lane columns x0+4*lane-1 .. +4.
__device__ __forceinline__ void load_row(float (&d)[6], const float* win, int r, int lane) {
  const float* p = win + r * band::kPitch + band::kLeft + 4 * lane;
  const float4 m = *reinterpret_cast<const float4*>(p);
  d[0] = clip_len(p[-1]);
  d[1] = clip_len(m.x);
  d[2] = clip_len(m.y);
  d[3] = clip_len(m.z);
  d[4] = clip_len(m.w);
  d[5] = clip_len(p[4]);
}

// CAS of a band row from the rows above and below, kept in registers.
struct CasRows {
  float sharpen;
  float a[6], b[6];  // window rows j and j + 1 (band rows j - 1 and j)

  __device__ __forceinline__ void start(const float* win, int j0, int lane) {
    load_row(a, win, j0, lane);
    load_row(b, win, j0 + 1, lane);
  }

  __device__ __forceinline__ void row(const float* win, int j, int lane, uint8_t (&o)[4]) {
    float s[6];
    load_row(s, win, j + 2, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = cas_pixel(a[e], a[e + 1], a[e + 2], b[e], b[e + 1], b[e + 2],
                       s[e], s[e + 1], s[e + 2], sharpen);
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      a[e] = b[e];
      b[e] = s[e];
    }
  }
};

}  // namespace

// C entry point (loaded with ctypes).  v: contiguous (C, H, W) float32;
// out: contiguous (C, H, W) uint8; bh: rows per band (capped at H and
// kMaxBand).  One launch of at most (SMs x resident blocks per SM) blocks
// on `stream`; does not synchronise; returns the first cudaError_t of the
// set-up calls and the launch.
extern "C" int vkr_cas_mono(const void* v, void* out, int C, int H, int W, int bh,
                            float sharpen, void* stream) {
  return band::launch(v, out, C, H, W, bh, CasRows{sharpen, {}, {}}, stream);
}
