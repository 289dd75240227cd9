// Quad store: the one-pass store of the cuFFT form's pre-CAS image
// (fft/cufft.py) into the four parity planes that K1 reads (Hopper, sm_90a).
//
// Replaces no TPU kernel.  On the JAX package's u = 2 routes the pre-CAS
// parity planes come straight out of the GEMMs (fft/dense.py::r2c_quad),
// and XLA fuses the scale and the int16 cast into them.  The cuFFT form
// ends in an inverse C2R whose output is the woven float32 image in raw
// uint8 units, unscaled; PyTorch would take four or more passes over it
// (the scale, the round, the clamp, the cast) and four more to split it
// into the planes.  This kernel does all of it in one pass.
//
// What it computes.  x: contiguous float32 (N, 2h, 2w) -> four contiguous
// planes P[ry][rx] (N, h, w), P[ry][rx][t][c] = f(x[2t + ry][2c + rx]),
// where f(v) = v * scale in float32 (is_i16 = 0), or, for int16 Q2.14
// (is_i16 = 1), rint(v * scale) saturated to [-32768, 32767]: round half
// to even, as ops/cas.py::to_i16_storage.  The caller folds the 1/255 of
// the uint8 input, the u^2 factor and the 2^14 of Q2.14 into scale; the
// fold is exact because 2^14 is a power of two (ops/fft_cuda.py).  Every
// N, h, w >= 1 runs (h <= 65535: a plane row is one grid row).
//
// Bound on this card.  One multiply, a round and two clamps per value
// against 4 bytes read and 2 (int16) or 4 (float32) written: device memory
// bounds it.  At the flagship batch of 8 frames, x (24, 2048, 4096) is
// 805 MB read and 403 MB written in int16: ~0.36 ms at 3.35 TB/s, 0.045 ms
// a frame.
//
// Design.  A block of 128 threads takes 256 columns of one plane row t of
// one plane n; each thread two neighbouring columns c, c + 1, i.e. a 2 x 4
// patch of x: two 16-byte loads (rows 2t and 2t + 1, columns 2c .. 2c + 3)
// when 2w is a multiple of 4 and x is on a 16-byte boundary, and two
// 4-byte (int16 pair) or 8-byte (float pair) stores to each plane.  A warp
// reads 512 contiguous bytes of each row and writes 128 (int16) contiguous
// bytes of each plane.  Otherwise (odd w, or x off that boundary) each
// value is loaded and stored alone, same arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;  // plane columns per thread

__device__ __forceinline__ int16_t store_one(float v, float scale, int16_t*) {
  const float q = rintf(__fmul_rn(v, scale));
  return (int16_t)fminf(fmaxf(q, -32768.0f), 32767.0f);
}
__device__ __forceinline__ float store_one(float v, float scale, float*) {
  return __fmul_rn(v, scale);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, float scale);
template <>
__device__ __forceinline__ void store_pair<int16_t>(int16_t* p, float a, float b, float scale) {
  short2 s;
  s.x = store_one(a, scale, p);
  s.y = store_one(b, scale, p);
  *reinterpret_cast<short2*>(p) = s;
}
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b, float scale) {
  *reinterpret_cast<float2*>(p) = make_float2(store_one(a, scale, p), store_one(b, scale, p));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
quad_store_kernel(const float* __restrict__ x, T* __restrict__ p00, T* __restrict__ p01,
                  T* __restrict__ p10, T* __restrict__ p11, int h, int w, float scale) {
  const int c = kCols * (blockIdx.x * kThreads + threadIdx.x);
  if (c >= w) return;
  const size_t t = blockIdx.y, n = blockIdx.z, W = 2 * (size_t)w;
  const float* r0 = x + (n * 2 * (size_t)h + 2 * t) * W + 2 * (size_t)c;
  const float* r1 = r0 + W;
  const size_t o = (n * (size_t)h + t) * (size_t)w + c;
  if (kVec && c + 1 < w) {
    const float4 a = *reinterpret_cast<const float4*>(r0);
    const float4 b = *reinterpret_cast<const float4*>(r1);
    store_pair<T>(p00 + o, a.x, a.z, scale);
    store_pair<T>(p01 + o, a.y, a.w, scale);
    store_pair<T>(p10 + o, b.x, b.z, scale);
    store_pair<T>(p11 + o, b.y, b.w, scale);
    return;
  }
  const int k_end = min(kCols, w - c);
  for (int k = 0; k < k_end; ++k) {
    p00[o + k] = store_one(r0[2 * k], scale, p00);
    p01[o + k] = store_one(r0[2 * k + 1], scale, p01);
    p10[o + k] = store_one(r1[2 * k], scale, p10);
    p11[o + k] = store_one(r1[2 * k + 1], scale, p11);
  }
}

template <typename T>
int launch(const float* x, void* p00, void* p01, void* p10, void* p11, int n, int h, int w,
           float scale, cudaStream_t st) {
  const dim3 grid((w + kThreads * kCols - 1) / (kThreads * kCols), h, n);
  // the 16-byte form: every row of x starts on a 16-byte boundary and each
  // thread's first column 2c is a multiple of 4
  const bool vec = w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  T* q[4] = {static_cast<T*>(p00), static_cast<T*>(p01), static_cast<T*>(p10),
             static_cast<T*>(p11)};
  if (vec) {
    quad_store_kernel<T, true><<<grid, kThreads, 0, st>>>(x, q[0], q[1], q[2], q[3], h, w, scale);
  } else {
    quad_store_kernel<T, false><<<grid, kThreads, 0, st>>>(x, q[0], q[1], q[2], q[3], h, w,
                                                            scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes): launches on `stream`, does not
// synchronise and returns the cudaError_t of the launch.  x: contiguous
// float32 (n, 2h, 2w); p00..p11: contiguous (n, h, w), int16 (is_i16) or
// float32, each on its own allocation or an aligned slice of one (the
// paired stores need 4-byte (int16) or 8-byte (float32) alignment, which
// an even w keeps); n, h <= 65535 (grid rows and planes).
extern "C" int vkr_quad_store(const void* x, void* p00, void* p01, void* p10, void* p11,
                              int n, int h, int w, int is_i16, float scale, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  return is_i16 ? launch<int16_t>(xf, p00, p01, p10, p11, n, h, w, scale, st)
                : launch<float>(xf, p00, p01, p10, p11, n, h, w, scale, st);
}
