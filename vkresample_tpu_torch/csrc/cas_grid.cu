// u-generic grid-parity fused CAS + quantize (Hopper, sm_90a).
//
// Replaces the Pallas kernel family behind
// vkresample_tpu/ops/cas_pallas.py::cas_parity_grid_planes (stencil math
// _grid_planes, kernel bodies _grid_strip_kernel and
// _grid_strip_slots_kernel).
//
// What it computes.  The transform hands over u*u pre-CAS phase planes
// P[ry][rx] (row-major), each (C, h, W), int16 Q2.14 (x 1/16384) or
// float32.  They are the woven image V[c, u*t+ry, u*s+rx] = P[ry][rx][c, t,
// s] of size (C, u*h, u*W).  With L = min(|V|, 1), every output pixel is
// the 3x3 clamp-to-edge FidelityFX-CAS of L (cas_common.cuh), written back
// as u*u uint8 planes of the same layout, so the woven image exists neither
// in device memory nor on the host.  u=2 is K1 (cas_quad.cu); the c2c grid
// route sends its p >= 3 planes (integer u, or the numerator of p/q) here.
//
// Bound on this card.  About 40 flops per output pixel against 2-4 bytes
// read and 1 written: device memory bounds it.  At 1280x720 -> 3840x2160
// (u=3, nine (3, 720, 1280) planes) it reads 49.8 MB of int16 (99.5 MB of
// float32) and writes 24.9 MB: ~22.3 us (int16) at 3.35 TB/s.
//
// Design.  One thread per plane position (c, t, s) computes all u*u output
// phases there.  A block covers kTX x ty positions (ty = 8 for u <= 4, 4 up
// to kMaxU, so the tile stays within 48 KB of shared memory at u = 8) and
// first stages the woven (ty*u+2) x (kTX*u+2) window of L values in dynamic
// shared memory.  The window's woven coordinates (Y, X) are clamped to [0,
// u*h-1] x [0, u*W-1] independently, then read from plane (Y mod u, X mod
// u) at (Y div u, X div u): the image border falls out of the clamp for
// every h, W >= 1, so neither the TPU kernel's band/strip DMA variants, its
// VMEM budget, its replicate-pad reroute nor its woven fallback have a
// counterpart here.  The interior window columns are loaded phase-major
// (all kTX positions of phase rx, then rx+1), so a warp reads kTX
// consecutive elements of one plane.  The plane pointers ride in a by-value
// argument struct, since the plane count varies with u.
#include "cas_common.cuh"

namespace {

constexpr int kTX = 32;      // plane columns per block
constexpr int kMaxU = 8;     // largest phase count (64 planes)

struct GridPlanes {
  const void* in[kMaxU * kMaxU];
  uint8_t* out[kMaxU * kMaxU];
};

__host__ __device__ inline int grid_ty(int u) { return u <= 4 ? 8 : 4; }

template <typename T>
__global__ void __launch_bounds__(kTX * 8)
cas_grid_kernel(const GridPlanes planes, int u, int h, int W, float sharpen) {
  extern __shared__ float tile[];
  const int ty = grid_ty(u);
  const int sw = kTX * u + 2, sh = ty * u + 2;
  const size_t plane = (size_t)h * (size_t)W;
  const size_t cbase = (size_t)blockIdx.z * plane;
  const int t0 = blockIdx.y * ty, s0 = blockIdx.x * kTX;
  const int ymax = u * h - 1, xmax = u * W - 1;
  const int nthreads = kTX * ty, inner = kTX * u;

  for (int i = threadIdx.y * kTX + threadIdx.x; i < sh * sw; i += nthreads) {
    const int r = i / sw, k = i - r * sw;
    // k < inner: interior column of phase k / kTX at position k % kTX;
    // the last two k are the west and east halo columns
    const int q = k < inner ? 1 + (k % kTX) * u + k / kTX : (k == inner ? 0 : sw - 1);
    const int Y = min(max(t0 * u - 1 + r, 0), ymax);
    const int X = min(max(s0 * u - 1 + q, 0), xmax);
    const int yq = Y / u, xq = X / u;
    const T* src = static_cast<const T*>(planes.in[(Y - yq * u) * u + (X - xq * u)]);
    tile[r * sw + q] = clip_len(src[cbase + (size_t)yq * W + xq]);
  }
  __syncthreads();

  const int t = t0 + threadIdx.y, s = s0 + threadIdx.x;
  if (t >= h || s >= W) return;
  const size_t o = cbase + (size_t)t * W + s;
  for (int ry = 0; ry < u; ++ry) {
    const int r = threadIdx.y * u + ry + 1;
    const float* up = tile + (r - 1) * sw;
    const float* mid = tile + r * sw;
    const float* dn = tile + (r + 1) * sw;
    for (int rx = 0; rx < u; ++rx) {
      const int q = threadIdx.x * u + rx + 1;
      planes.out[ry * u + rx][o] =
          cas_pixel(up[q - 1], up[q], up[q + 1], mid[q - 1], mid[q], mid[q + 1],
                    dn[q - 1], dn[q], dn[q + 1], sharpen);
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes).  in: u*u pointers to contiguous
// (C, h, W) planes of one dtype (is_i16: int16 Q2.14, else float32),
// row-major (ry, rx); out: u*u pointers to contiguous (C, h, W) uint8
// outputs.  Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch.
extern "C" int vkr_cas_grid(const void* const* in, void* const* out, int u,
                            int C, int h, int W, int is_i16, float sharpen,
                            void* stream) {
  if (u < 1 || u > kMaxU || C <= 0 || h <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)u * h > 0x7fffffffLL || (long long)u * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  GridPlanes planes = {};
  for (int i = 0; i < u * u; ++i) {
    planes.in[i] = in[i];
    planes.out[i] = static_cast<uint8_t*>(out[i]);
  }
  const int ty = grid_ty(u);
  const dim3 block(kTX, ty);
  const dim3 grid((W + kTX - 1) / kTX, (h + ty - 1) / ty, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(ty * u + 2) * (size_t)(kTX * u + 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_i16) {
    cas_grid_kernel<int16_t><<<grid, block, smem, st>>>(planes, u, h, W, sharpen);
  } else {
    cas_grid_kernel<float><<<grid, block, smem, st>>>(planes, u, h, W, sharpen);
  }
  return (int)cudaGetLastError();
}
