// Woven CAS + quantize in one persistent launch on a warp-specialized
// streaming pipeline (Hopper, sm_90a).
//
// Replaces vkresample_tpu/ops/cas_pallas.py::cas_quantize_mono (kernel
// body _cas_mono_kernel: one invocation, an in-kernel loop over bands of bh
// rows, double-buffered manual DMA in and out; stencil math _cas_band).
//
// What it computes.  A float32 pre-CAS image v (C, H, W) goes to the uint8
// image (C, H, W): the 3x3 clamp-to-edge CAS of L = min(|v|, 1) with the
// rsqrt blend (cas_common.cuh::cas_pixel), then (int)clamp(out*255, 0,
// 255) -- K3's arithmetic, so the output equals K3's (cas_rows.cu at u =
// 1) on every pixel.
//
// Bound on this card.  About 40 flops per output pixel against 4 bytes
// read and 1 written: device memory bounds it.  At (3, 2048, 4096) it reads
// 100.7 MB and writes 25.2 MB: ~37.6 us at the 3.35 TB/s peak.
//
// Design.  The JAX kernel's one launch with an in-kernel band loop stays:
// stream_pipeline.cuh's persistent grid, where a producer warp keeps bulk
// copies of row chunks in flight into each consumer warp's ring of mbarrier
// stages.  What changed from _cas_mono_kernel and from this kernel's first
// design (band_pipeline.cuh, two (bh+2)-row windows a block, two
// __syncthreads an item): no band of bh rows is staged whole and no warp
// waits for another; bh is the segment height of the balanced static runs,
// and a consumer warp streams down its run with the rows above and below
// in registers (a 3-row x 6-column window of L values per lane: one float4
// and two scalar shared loads per row), evaluating its four columns while
// the producer fills the stages ahead.  With the copies off the consumers'
// path the kernel is bound by instructions, so the four outputs of a lane
// come from CasRows::row, cas_pixel's arithmetic with its exact steps
// shared between the four windows.  Every H, W, bh >= 1 runs: the TPU
// kernel's bh < 32 / W % 128 / H < bh + 16 reroute to the woven kernel has
// no counterpart here.
#include "cas_common.cuh"
#include "stream_pipeline.cuh"

namespace {

// rsqrtf of a normal float.  rsqrtf rescales a denormal argument around the
// hardware reciprocal square root; the blend's argument is floored at
// 1e-30, a normal float, where the two give the same bits.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// quantize_u8 as one conversion: a float-to-u8 truncation saturates to
// [0, 255] and takes NaN to 0, which is what the two clamps and the
// truncation of quantize_u8 give for every float.
__device__ __forceinline__ uint32_t quantize_u8_cvt(float v) {
  uint32_t r;
  asm("cvt.rzi.u8.f32 %0, %1;" : "=r"(r) : "f"(__fmul_rn(v, 255.0f)));
  return r;
}

// The woven CAS of a row from the rows above and below, kept in registers.
// row() gives, bit for bit, cas_pixel's four outputs: the same float
// operations on the same values, with only exact steps regrouped.  L has
// no NaN and no -0 (L = min(|v|, 1)), so min and max are exact,
// associative and commutative, and the four windows' min/max trees share
// their pairs: the north/south pair of each column and the centre row's
// adjacent pairs.  Then rsqrt_normal and quantize_u8_cvt as above.
struct CasRows {
  float sharpen;

  // the L values of columns x-1 .. x+4, repeated at the image's edges
  struct Row {
    float v[6];
  };

  static __device__ __forceinline__ void load(Row& d, const float* p, int x, int W) {
    const float4 m = *reinterpret_cast<const float4*>(p);
    d.v[1] = clip_len(m.x);
    d.v[2] = clip_len(m.y);
    d.v[3] = clip_len(m.z);
    d.v[4] = clip_len(m.w);
    d.v[0] = x == 0 ? d.v[1] : clip_len(p[-1]);
    d.v[5] = x + 4 >= W ? d.v[4] : clip_len(p[4]);
  }

  __device__ __forceinline__ void row(const Row& n, const Row& c, const Row& s,
                                      uint8_t (&o)[4]) const {
    float vmin[6], vmax[6], hmin[5], hmax[5];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      vmin[j] = fminf(n.v[j], s.v[j]);
      vmax[j] = fmaxf(n.v[j], s.v[j]);
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      hmin[j] = fminf(c.v[j], c.v[j + 1]);
      hmax[j] = fmaxf(c.v[j], c.v[j + 1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the cross (n, s, c, w, e) and the corners of column e + 1's window
      const float min_cross = fminf(vmin[e + 1], fminf(hmin[e], c.v[e + 2]));
      const float max_cross = fmaxf(vmax[e + 1], fmaxf(hmax[e], c.v[e + 2]));
      const CasRatio r = cas_select(min_cross, fminf(min_cross, fminf(vmin[e], vmin[e + 2])),
                                    max_cross, fmaxf(max_cross, fmaxf(vmax[e], vmax[e + 2])));
      const float sc = __fmul_rn(__fmul_rn(-sharpen, r.num),
                                 rsqrt_normal(fmaxf(__fmul_rn(r.num, r.den), 1e-30f)));
      o[e] = (uint8_t)quantize_u8_cvt(cas_value(n.v[e + 1], c.v[e], c.v[e + 1], c.v[e + 2],
                                                s.v[e + 1], sc));
    }
  }
};

}  // namespace

// C entry point (loaded with ctypes).  v: contiguous (C, H, W) float32;
// out: contiguous (C, H, W) uint8; bh: rows per segment, any bh >= 1 (the
// output does not depend on it).  One launch of at most one block per SM
// on `stream`; does not synchronise; returns the first cudaError_t of the
// set-up calls and the launch.
extern "C" int vkr_cas_mono(const void* v, void* out, int C, int H, int W, int bh,
                            float sharpen, void* stream) {
  return ring::launch(v, out, C, H, W, bh, CasRows{sharpen}, stream);
}
