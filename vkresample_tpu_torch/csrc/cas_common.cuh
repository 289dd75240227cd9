// The per-pixel FidelityFX-CAS evaluation shared by the port's CAS kernels
// (cas_quad.cu, cas_parity.cu, cas_woven.cu).
//
// With L = min(|V|, 1) (int16 Q2.14 input scaled by 1/16384 first), every
// output pixel is the 3x3 clamp-to-edge CAS of L (VkResample.cpp:887-923):
// two-level min/max over cross and corners, scale = -s * num * rsqrt(
// max(num*den, 1e-30)), out = (c + scale*(n+s+w+e)) / (1 + 4*scale), then
// (int)clamp(out*255, 0, 255) -- the JAX kernels' _cas_blend
// (vkresample_tpu/ops/cas_pallas.py:637-656).  Written with explicit
// round-to-nearest intrinsics (no FMA contraction) in the plain PyTorch
// version's operation order (ops/cas_cuda.py::_blend_u8), so the kernels
// round like it op for op.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clip_len(float v) { return fminf(fabsf(v), 1.0f); }
__device__ __forceinline__ float clip_len(int16_t v) {
  return fminf(fabsf(__fmul_rn((float)v, 1.0f / 16384.0f)), 1.0f);
}

__device__ __forceinline__ uint8_t cas_pixel(
    float nw, float n, float ne, float w, float c, float e,
    float sw, float s, float se, float sharpen) {
  const float xmin = fminf(w, e), xmax = fmaxf(w, e);
  const float min_cross = fminf(fminf(n, s), fminf(c, xmin));
  const float max_cross = fmaxf(fmaxf(n, s), fmaxf(c, xmax));
  const float cmin = fminf(fminf(nw, ne), fminf(sw, se));
  const float cmax = fmaxf(fmaxf(nw, ne), fmaxf(sw, se));
  const float min_all = fminf(min_cross, cmin);
  const float max_all = fmaxf(max_cross, cmax);
  const float minlen = __fmul_rn(0.5f, __fadd_rn(min_cross, min_all));
  const float maxlen = __fmul_rn(0.5f, __fadd_rn(max_cross, max_all));
  // _cas_blend: sqrt(num/den) as num * rsqrt(num*den), floored so num == 0
  // gives 0 and not 0 * inf
  const float a = minlen, b = __fsub_rn(1.0f, minlen);
  const float cq = __fsub_rn(1.0f, maxlen), d = maxlen;
  const bool pred = __fmul_rn(a, d) < __fmul_rn(cq, b);
  const float num = pred ? a : cq;
  const float den = pred ? b : d;
  const float sc = __fmul_rn(__fmul_rn(-sharpen, num),
                             rsqrtf(fmaxf(__fmul_rn(num, den), 1e-30f)));
  const float nsum = __fadd_rn(__fadd_rn(n, s), __fadd_rn(w, e));
  const float out = __fdiv_rn(__fadd_rn(c, __fmul_rn(sc, nsum)),
                              __fadd_rn(1.0f, __fmul_rn(4.0f, sc)));
  const float q = fminf(fmaxf(__fmul_rn(out, 255.0f), 0.0f), 255.0f);
  return (uint8_t)(int)q;
}

// 3x3 CAS of the woven window centred on tile[r][q] (row pitch kSW).
template <int kSW>
__device__ __forceinline__ uint8_t cas_at(float (*tile)[kSW], int r, int q,
                                          float sharpen) {
  return cas_pixel(tile[r - 1][q - 1], tile[r - 1][q], tile[r - 1][q + 1],
                   tile[r][q - 1], tile[r][q], tile[r][q + 1],
                   tile[r + 1][q - 1], tile[r + 1][q], tile[r + 1][q + 1],
                   sharpen);
}

}  // namespace
