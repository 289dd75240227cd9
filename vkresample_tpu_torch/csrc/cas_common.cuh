// The per-pixel FidelityFX-CAS evaluation shared by the port's CAS kernels
// (cas_grid.cu: K4 and K1; cas_rows.cu: K5, K3, K2 and K6; cas_mono.cu,
// ycas.cu), and its final quantize, which the copy-quantize probes
// (copy_quantize.cu; cas_rows.cu's copy instance) run alone.
//
// With L = min(|V|, 1) (int16 Q2.14 input scaled by 1/16384 first), every
// output pixel is the 3x3 clamp-to-edge CAS of L (VkResample.cpp:887-923):
// two-level min/max over cross and corners, scale = -s * sqrt(num/den) for
// the smaller of minlen/(1-minlen) and (1-maxlen)/maxlen, out = (c +
// scale*(n+s+w+e)) / (1 + 4*scale), then (int)clamp(out*255, 0, 255).
// Two evaluations of the scale exist in the JAX kernels, and each has one
// here:
//   cas_pixel       num * rsqrt(max(num*den, 1e-30)), _cas_blend
//                   (vkresample_tpu/ops/cas_pallas.py:637-656); every
//                   kernel but K6
//   cas_pixel_sqrt  sqrt(max(num/den, 0)) with an IEEE divide,
//                   _cas_blk_kernel (cas_pallas.py:2408-2424); K6
// The two differ by 1 LSB on rare boundary pixels.  Both are written with
// explicit round-to-nearest intrinsics (no FMA contraction) in the plain
// PyTorch version's operation order (ops/cas_cuda.py::_blend_u8), so the
// kernels round like it op for op.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clip_len(float v) { return fminf(fabsf(v), 1.0f); }
__device__ __forceinline__ float clip_len(int16_t v) {
  return fminf(fabsf(__fmul_rn((float)v, 1.0f / 16384.0f)), 1.0f);
}

// The blend's selected quotient: sqrt(num/den) is the smaller of
// minlen/(1-minlen) and (1-maxlen)/maxlen, picked by cross-multiplication.
// The selected denominator is never 0 (minlen = 1 forces the other branch,
// maxlen = 0 likewise, cas_pallas.py:186-190).
struct CasRatio {
  float num, den;
};

// The quotient from the two-level minima and maxima of the window.
__device__ __forceinline__ CasRatio cas_select(float min_cross, float min_all,
                                               float max_cross, float max_all) {
  const float minlen = __fmul_rn(0.5f, __fadd_rn(min_cross, min_all));
  const float maxlen = __fmul_rn(0.5f, __fadd_rn(max_cross, max_all));
  const float a = minlen, b = __fsub_rn(1.0f, minlen);
  const float cq = __fsub_rn(1.0f, maxlen), d = maxlen;
  const bool pred = __fmul_rn(a, d) < __fmul_rn(cq, b);
  return {pred ? a : cq, pred ? b : d};
}

__device__ __forceinline__ CasRatio cas_ratio(
    float nw, float n, float ne, float w, float c, float e,
    float sw, float s, float se) {
  const float xmin = fminf(w, e), xmax = fmaxf(w, e);
  const float min_cross = fminf(fminf(n, s), fminf(c, xmin));
  const float max_cross = fmaxf(fmaxf(n, s), fmaxf(c, xmax));
  const float cmin = fminf(fminf(nw, ne), fminf(sw, se));
  const float cmax = fmaxf(fmaxf(nw, ne), fmaxf(sw, se));
  return cas_select(min_cross, fminf(min_cross, cmin), max_cross, fmaxf(max_cross, cmax));
}

// (int)clamp(v*255, 0, 255) as uint8: ops/cas.py::quantize_u8.
__device__ __forceinline__ uint8_t quantize_u8(float v) {
  return (uint8_t)(int)fminf(fmaxf(__fmul_rn(v, 255.0f), 0.0f), 255.0f);
}

// out = (c + sc*(n+s+w+e)) / (1 + 4*sc), before the quantize.
__device__ __forceinline__ float cas_value(float n, float w, float c, float e,
                                           float s, float sc) {
  const float nsum = __fadd_rn(__fadd_rn(n, s), __fadd_rn(w, e));
  return __fdiv_rn(__fadd_rn(c, __fmul_rn(sc, nsum)), __fadd_rn(1.0f, __fmul_rn(4.0f, sc)));
}

// cas_value, then quantize_u8.
__device__ __forceinline__ uint8_t cas_out(float n, float w, float c, float e,
                                           float s, float sc) {
  return quantize_u8(cas_value(n, w, c, e, s, sc));
}

__device__ __forceinline__ uint8_t cas_pixel(
    float nw, float n, float ne, float w, float c, float e,
    float sw, float s, float se, float sharpen) {
  const CasRatio r = cas_ratio(nw, n, ne, w, c, e, sw, s, se);
  // _cas_blend: sqrt(num/den) as num * rsqrt(num*den), floored so num == 0
  // gives 0 and not 0 * inf
  const float sc = __fmul_rn(__fmul_rn(-sharpen, r.num),
                             rsqrtf(fmaxf(__fmul_rn(r.num, r.den), 1e-30f)));
  return cas_out(n, w, c, e, s, sc);
}

__device__ __forceinline__ uint8_t cas_pixel_sqrt(
    float nw, float n, float ne, float w, float c, float e,
    float sw, float s, float se, float sharpen) {
  const CasRatio r = cas_ratio(nw, n, ne, w, c, e, sw, s, se);
  // _cas_blk_kernel: -s * sqrt(max(num/den, 0)), an IEEE divide and sqrt.
  // num is +0 wherever the window holds an L of 1 on both levels (maxlen =
  // 1) or of 0 (minlen = 0), and then the quotient and its root are +0: such
  // lanes divide 1 and take the root of 1 instead and select +0, so that no
  // lane sends a zero operand down the divide's or the root's slow path.
  const bool zero = !(r.num > 0.0f);
  const float q = __fdiv_rn(zero ? 1.0f : r.num, r.den);
  const float root = __fsqrt_rn(zero ? 1.0f : fmaxf(q, 0.0f));
  const float sc = __fmul_rn(-sharpen, zero ? 0.0f : root);
  return cas_out(n, w, c, e, s, sc);
}

// Staging helpers of the redesigned kernels (cas_grid.cu, cas_rows.cu):
// cp.async copies of the stored dtype into shared memory, and the L
// values of 4 adjacent stored values when they go into registers.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// One element: a 4-byte cp.async for float32; cp.async has no 2-byte form,
// so an int16 goes through a register.
__device__ __forceinline__ void copy_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void copy_elem(int16_t* dst, const int16_t* src) { *dst = __ldg(src); }

// The L values of 4 adjacent stored values (16 bytes of float32, 8 of int16).
__device__ __forceinline__ void load4(float (&d)[4], const float* p) {
  const float4 m = *reinterpret_cast<const float4*>(p);
  d[0] = clip_len(m.x);
  d[1] = clip_len(m.y);
  d[2] = clip_len(m.z);
  d[3] = clip_len(m.w);
}
__device__ __forceinline__ void load4(float (&d)[4], const int16_t* p) {
  const short4 m = *reinterpret_cast<const short4*>(p);
  d[0] = clip_len((int16_t)m.x);
  d[1] = clip_len((int16_t)m.y);
  d[2] = clip_len((int16_t)m.z);
  d[3] = clip_len((int16_t)m.w);
}

}  // namespace
