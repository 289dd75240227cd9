// The persistent band pipeline shared by cas_mono.cu (K7, the woven CAS) and
// copy_quantize.cu (K10b, the same data movement with a plain quantize).
//
// One launch of at most (SMs x resident blocks per SM) blocks walks the work
// items (channel, band of R = min(bh, H, 192) rows, strip of 128 columns)
// with a grid stride, each block through two shared-memory windows of (R+2)
// x (128+8) float32: while it computes item g from one window, the cp.async
// copies of item g + gridDim.x fill the other.  Window rows and columns are
// the item's rows and columns plus a one-pixel halo, fetched at clamped
// addresses, so the window holds exactly the clamp-to-edge values (no zero
// fill to fix up).  Interior columns go as 16-byte copies where W % 4 == 0
// and v is 16-byte aligned, else every element as a 4-byte copy.  Ordering
// per iteration: start the next item's copies and commit them as a group;
// wait for all but that newest group (this item's window has landed for
// this thread); __syncthreads (and for every thread); compute;
// __syncthreads, so no thread refills this window in the next iteration
// while another still reads it (the write-after-read hazard).  Compute:
// each warp takes a contiguous run of the band's rows, each lane four
// adjacent columns, walking down the rows; a Body computes the four uint8
// outputs of a row from the window, and they go out as one 32-bit store
// where W % 4 == 0.  Every H, W, bh >= 1 runs.
//
// A Body is a small struct, copied into each thread:
//   __device__ void start(const float* win, int j0, int lane);   // before row j0
//   __device__ void row(const float* win, int j, int lane, uint8_t (&o)[4]);
// where window row j + 1 holds band row j and window column
// kLeft + 4*lane + e holds the lane's column e.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace band {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 128;          // columns per item, four per lane
constexpr int kLeft = 4;             // window column of the strip's first column
constexpr int kPitch = kStrip + 8;   // window row: 3 pad, west halo, strip, east halo, 3 pad
constexpr int kChunks = kStrip / 4;  // 16-byte copies per window row
constexpr int kMaxBand = 192;        // two (192+2) x 136 float windows fit in 227 KB

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

struct Item {
  int c, y0, x0;
};

__device__ __forceinline__ Item item_of(int g, int nbands, int nstrips, int R) {
  const int s = g % nstrips, t = g / nstrips;
  return {t / nbands, (t % nbands) * R, s * kStrip};
}

// Start the copies of item `it`'s window (rows y0-1 .. y0+R, columns x0-1
// .. x0+128, clamped) into `win`.
template <bool kVec>
__device__ __forceinline__ void load_window(float* win, const float* __restrict__ v,
                                            Item it, int R, int H, int W) {
  const float* vc = v + (size_t)it.c * H * W;
  constexpr int kPerRow = kVec ? kChunks + 2 : kStrip + 2;
  for (int k = threadIdx.x; k < (R + 2) * kPerRow; k += kThreads) {
    const int r = k / kPerRow, q = k - r * kPerRow;
    const float* src = vc + (size_t)min(max(it.y0 - 1 + r, 0), H - 1) * W;
    float* dst = win + r * kPitch;
    if (kVec && q < kChunks) {
      const int X = it.x0 + 4 * q;
      if (X < W) {
        cp_async16(dst + kLeft + 4 * q, src + X);
      } else {  // past the right edge: the clamped column W-1
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + kLeft + 4 * q + e, src + W - 1);
      }
    } else {
      // kVec: the two halo columns (q = kChunks, kChunks + 1); else every
      // column x0 - 1 + q
      const int col = kVec ? (q == kChunks ? -1 : kStrip) : q - 1;
      cp_async4(dst + kLeft + col, src + min(max(it.x0 + col, 0), W - 1));
    }
  }
}

template <bool kVec, class Body>
__device__ __forceinline__ void compute_item(const float* win, uint8_t* __restrict__ out,
                                             Item it, int R, int H, int W, Body body) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = min(R, H - it.y0);  // valid rows of this band
  const int per = (rows + kWarps - 1) / kWarps;
  const int j0 = warp * per, j1 = min(j0 + per, rows);
  const int x = it.x0 + 4 * lane;
  if (x >= W) return;
  uint8_t* ob = out + ((size_t)it.c * H + it.y0) * W + x;
  if (j0 < j1) body.start(win, j0, lane);
  for (int j = j0; j < j1; ++j) {
    uint8_t o[4];
    body.row(win, j, lane, o);
    uint8_t* dst = ob + (size_t)j * W;
    if (kVec) {
      *reinterpret_cast<uint32_t*>(dst) =
          o[0] | (o[1] << 8) | (o[2] << 16) | ((uint32_t)o[3] << 24);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (x + e < W) dst[e] = o[e];
      }
    }
  }
}

template <bool kVec, class Body>
__global__ void __launch_bounds__(kThreads)
band_kernel(const float* __restrict__ v, uint8_t* __restrict__ out, int H, int W,
            int R, int nbands, int nstrips, int total, Body body) {
  extern __shared__ __align__(16) float smem[];
  const int wsize = (R + 2) * kPitch;
  int g = blockIdx.x;
  load_window<kVec>(smem, v, item_of(g, nbands, nstrips, R), R, H, W);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int k = 0; g < total; g += gridDim.x, ++k) {
    float* cur = smem + (k & 1) * wsize;
    const int next = g + gridDim.x;
    if (next < total) {
      load_window<kVec>(smem + ((k + 1) & 1) * wsize, v, item_of(next, nbands, nstrips, R),
                        R, H, W);
    }
    asm volatile("cp.async.commit_group;\n" ::);      // possibly empty
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this item's copies landed
    __syncthreads();                                  // ... every thread's
    compute_item<kVec>(cur, out, item_of(g, nbands, nstrips, R), R, H, W, body);
    __syncthreads();  // no refill of `cur` (next iteration) while it is read
  }
}

// Launch band_kernel for v: contiguous (C, H, W) float32, out: contiguous
// (C, H, W) uint8, bh rows per band (capped at H and kMaxBand), on
// `stream`; does not synchronise; returns the first cudaError_t of the
// set-up calls and the launch.
template <class Body>
int launch(const void* v, void* out, int C, int H, int W, int bh, Body body, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0 || bh <= 0) return (int)cudaErrorInvalidValue;
  const int R = min(min(bh, H), kMaxBand);
  const int nbands = 1 + (H - 1) / R, nstrips = 1 + (W - 1) / kStrip;
  const long long total = (long long)C * nbands * nstrips;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(R + 2) * kPitch * sizeof(float);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  void (*kern)(const float*, uint8_t*, int, int, int, int, int, int, Body) =
      vec ? band_kernel<true, Body> : band_kernel<false, Body>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  }
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)(total < (long long)sms * per_sm ? total : (long long)sms * per_sm);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<uint8_t*>(out), H, W, R, nbands, nstrips,
      (int)total, body);
  return (int)cudaGetLastError();
}

}  // namespace band
}  // namespace
