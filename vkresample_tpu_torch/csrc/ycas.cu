// Fused y GEMM + rows-parity CAS + quantize, u=2 (Hopper, sm_90a): K8
// (parity planes out) and K9 (woven image out).
//
// Replaces the Pallas kernels behind
// vkresample_tpu/ops/ycas_pallas.py::ycas_parity_u2 (_ycas_parity_kernel)
// and ::ycas_u2 (_ycas_kernel); stencil math _parity_planes and _cas_core /
// _cas_blend of ops/cas_pallas.py.
//
// What it computes.  The u=2 rows route's x pass hands over the sample
// output rows U (C, h, W), int16 Q2.14 (x 1/16384) or float32, and the
// rank-r y-Nyquist correction rows T2 (C, r, W) float32 (r may be 0).  The
// odd output rows are the y GEMM O = YT[:, :h] . U + YT[:, h:] . T2, with YT
// (h, h + r) float32 (fft/dense.py::ycas_bank).  With the woven image V[2t] =
// U[t], V[2t+1] = O[t], every output pixel is the 3x3 clamp-to-edge CAS of
// L = min(|V|, 1) (cas_common.cuh).  K8 writes the even and odd rows as
// planes E, D (C, h, W) uint8, K9 writes the woven (C, 2h, W) uint8 image.
// O stays float32 inside the kernel (never Q2.14-rounded, as in the JAX
// kernels) and, like the woven image, never reaches device memory.
//
// Bound on this card.  The GEMM: 2*C*h*(h+r)*W fp32 operations, ~20.2
// GFLOP at 1440x1080 -> 2880x2160 (h = 1080, W = 2880), ~0.30 ms at the
// 67 TFLOP/s fp32 peak outside the tensor cores, against ~42 MB (int16)
// moved, ~13 us at 3.35 TB/s: operations bound it.
//
// Design.  One block of 128 threads per (channel, strip of kBW = 62
// output columns, band of kBO = 63 plane rows [a, a+63)).  It computes the
// kM x kN = 64 x 64 tile of O rows [a-1, a+63) (the north halo row
// recomputed) by columns [x0-1, x0+63) (both halo columns recomputed), row
// and column indices clamped to the plane, so every tile value is the
// clamp-to-edge value the CAS wants.  The K = h + r contraction runs over
// chunks of kBK = 16: YT rows and [U; T2] rows are staged in shared memory
// (U dequantized on load, exactly from_i16_storage), the next chunk's
// global loads in flight in registers while the current chunk is summed,
// and each thread keeps an 8 x 4 register tile of O, its operands read as
// float4 from shared memory, in fp32 FMA (no tensor cores: a 3xTF32 or
// bf16x3 form is later work).  Then the O tile and U rows [a, a+63]
// (clamped at h-1) are held as L in shared memory and each thread
// evaluates both output parities per position with the per-parity
// stencil of _parity_planes: even row 2t has N = O[t-1]
// (itself at t = 0), C = U[t], S = O[t]; odd row 2t+1 has N = U[t], C =
// O[t], S = U[t+1] (itself at t = h-1).  Every load is clamped, so any
// h, W >= 1 and r >= 0 runs: the TPU kernels' strip/halo DMA geometry
// (Wb, bo, HALO, RPAD) and its support gate have no counterpart here.
// Shared memory stays at 40 KB, under the 48 KB static limit.
#include "cas_common.cuh"

namespace {

constexpr int kM = 64;           // O rows per GEMM tile: kBO band rows + 1 halo
constexpr int kN = 64;           // columns per GEMM tile: kBW + 2 halo
constexpr int kBO = kM - 1;      // plane rows per band
constexpr int kBW = kN - 2;      // output columns per strip
constexpr int kBK = 16;          // contraction chunk staged in shared memory
constexpr int kThreads = 128;    // 8 x 16 threads, 8 x 4 O values each
constexpr int kAP = kM + 4;      // As row pitch (padded against bank conflicts)

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(int16_t v) {
  return __fmul_rn((float)v, 1.0f / 16384.0f);
}

template <typename T, bool kWovenOut>
__global__ void __launch_bounds__(kThreads)
ycas_kernel(const T* __restrict__ U, const float* __restrict__ T2,
            const float* __restrict__ YT, uint8_t* __restrict__ out0,
            uint8_t* __restrict__ out1, int h, int W, int r, float sharpen) {
  __shared__ __align__(16) float As[kBK][kAP];  // YT chunk, As[k][m]
  __shared__ __align__(16) float Bs[kBK][kN];   // [U; T2] chunk, Bs[k][n]
  __shared__ float Ot[kM][kN];                  // L of O rows a-1 .. a+kBO-1
  __shared__ float Ut[kM][kN];                  // L of U rows a .. a+kBO

  const int tid = threadIdx.x;
  const size_t c = blockIdx.z;
  const int a = blockIdx.y * kBO;
  const int x0 = blockIdx.x * kBW;
  const int K = h + r;
  const T* Uc = U + c * (size_t)h * (size_t)W;
  const float* Tc = r > 0 ? T2 + c * (size_t)r * (size_t)W : nullptr;

  // staging roles: A row am, contraction ak..ak+7; B column bn, rows bk + 2j
  const int am = tid >> 1, ak = (tid & 1) * 8;
  const int bn = tid & (kN - 1), bk = tid >> 6;
  const float* yrow = YT + (size_t)min(max(a - 1 + am, 0), h - 1) * (size_t)K;
  const int gx = min(max(x0 - 1 + bn, 0), W - 1);
  // the chunk staged next, loaded into registers while the current one is
  // summed (U kept raw, so no instruction waits on the loads before the
  // chunk is stored); zero past K
  float ra[8] = {}, rt[8] = {};
  T ru[8] = {};
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + ak + j;
      ra[j] = k < K ? yrow[k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + bk + 2 * j;
      if (k < h) {
        ru[j] = Uc[(size_t)k * W + gx];
      } else {
        rt[j] = k < K ? Tc[(size_t)(k - h) * W + gx] : 0.0f;
      }
    }
  };
  // register tile: O rows ty*8 .. +7, columns tx*4 .. +3
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][4] = {};

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 8; ++j) As[ak + j][am] = ra[j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Bs[bk + 2 * j][bn] = k0 + bk + 2 * j < h ? load_f(ru[j]) : rt[j];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) Ot[ty * 8 + i][tx * 4 + j] = clip_len(acc[i][j]);
  }
  for (int i = tid; i < kM * kN; i += kThreads) {
    const int s = i / kN, n = i - s * kN;
    const int t = min(a + s, h - 1);
    const int X = min(max(x0 - 1 + n, 0), W - 1);
    Ut[s][n] = clip_len(Uc[(size_t)t * W + X]);
  }
  __syncthreads();

  const int q = (tid & (kN - 1)) + 1;  // tile column of this thread's pixels
  const int x = x0 + q - 1;
  if (q > kBW || x >= W) return;
  for (int s = tid / kN; s < kBO; s += kThreads / kN) {
    const int t = a + s;
    if (t >= h) break;
    const float* nE = t == 0 ? Ut[0] : Ot[s];          // even row's north
    const float* sD = t == h - 1 ? Ot[s + 1] : Ut[s + 1];  // odd row's south
    const float* u0 = Ut[s];
    const float* o1 = Ot[s + 1];
    const uint8_t even = cas_pixel(nE[q - 1], nE[q], nE[q + 1], u0[q - 1], u0[q],
                                   u0[q + 1], o1[q - 1], o1[q], o1[q + 1], sharpen);
    const uint8_t odd = cas_pixel(u0[q - 1], u0[q], u0[q + 1], o1[q - 1], o1[q],
                                  o1[q + 1], sD[q - 1], sD[q], sD[q + 1], sharpen);
    if (kWovenOut) {
      uint8_t* oc = out0 + c * 2 * (size_t)h * (size_t)W;
      oc[(size_t)(2 * t) * W + x] = even;
      oc[(size_t)(2 * t + 1) * W + x] = odd;
    } else {
      const size_t o = c * (size_t)h * (size_t)W + (size_t)t * W + x;
      out0[o] = even;
      out1[o] = odd;
    }
  }
}

template <bool kWovenOut>
int launch(const void* U, const void* T2, const void* YT, void* out0, void* out1,
           int C, int h, int W, int r, int is_i16, float sharpen, void* stream) {
  if (C <= 0 || h <= 0 || W <= 0 || r < 0 || (r > 0 && T2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBW - 1) / kBW, (h + kBO - 1) / kBO, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t2 = static_cast<const float*>(T2);
  const float* yt = static_cast<const float*>(YT);
  uint8_t* o0 = static_cast<uint8_t*>(out0);
  uint8_t* o1 = static_cast<uint8_t*>(out1);
  if (is_i16) {
    ycas_kernel<int16_t, kWovenOut><<<grid, kThreads, 0, st>>>(
        static_cast<const int16_t*>(U), t2, yt, o0, o1, h, W, r, sharpen);
  } else {
    ycas_kernel<float, kWovenOut><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(U), t2, yt, o0, o1, h, W, r, sharpen);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  U: contiguous (C, h, W) (is_i16:
// int16 Q2.14, else float32); T2: contiguous (C, r, W) float32, null when
// r = 0; YT: contiguous (h, h + r) float32.  K8 writes the even and odd row
// planes E, D, contiguous (C, h, W) uint8; K9 the woven (C, 2h, W) uint8
// image.  Launch on `stream`, do not synchronise, return the cudaError_t of
// the launch.
extern "C" int vkr_ycas_parity_u2(const void* U, const void* T2, const void* YT,
                                  void* E, void* D, int C, int h, int W, int r,
                                  int is_i16, float sharpen, void* stream) {
  return launch<false>(U, T2, YT, E, D, C, h, W, r, is_i16, sharpen, stream);
}

extern "C" int vkr_ycas_u2(const void* U, const void* T2, const void* YT, void* out,
                           int C, int h, int W, int r, int is_i16, float sharpen,
                           void* stream) {
  return launch<true>(U, T2, YT, out, nullptr, C, h, W, r, is_i16, sharpen, stream);
}
