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
// Design.  The work items are (channel, band of R = min(bh, H, 192) rows,
// strip of 128 columns).  The grid is at most the SM count times the
// blocks that fit on one SM, and each block walks the items g, g +
// gridDim.x, ... with two shared-memory windows of (R+2) x (128+2) float32:
// while it computes item g from one window, the cp.async copies of item g
// + gridDim.x fill the other.  Window rows and columns are the item's rows
// and columns plus a one-pixel halo, fetched at clamped addresses, so the
// window holds exactly the clamp-to-edge values (no zero fill to fix up).
// Interior columns go as 16-byte copies where W % 4 == 0 and v is 16-byte
// aligned, else every element as a 4-byte copy.  Ordering per iteration:
// start the next item's copies and commit them as a group; wait for all
// but that newest group (this item's window has landed for this thread);
// __syncthreads (and for every thread); compute; __syncthreads, so no
// thread refills this window in the next iteration while another still
// reads it (the write-after-read hazard the JAX kernel guards with its
// output-DMA wait).  Compute: each warp takes a contiguous run of the
// band's rows, each lane four adjacent columns, walking down the rows with
// a 3-row x 6-column register window of L values (one float4 and two
// scalar shared loads per row); the four uint8 outputs go straight from
// registers, as one 32-bit store where W % 4 == 0.  Every H, W, bh >= 1
// runs: the TPU kernel's bh < 32 / W % 128 / H < bh + 16 reroute to the
// woven kernel has no counterpart here.
#include "cas_common.cuh"

namespace {

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

// The 6 L values of window row r around lane columns x0+4*lane-1 .. +4.
__device__ __forceinline__ void load_row(float (&d)[6], const float* win, int r, int lane) {
  const float* p = win + r * kPitch + kLeft + 4 * lane;
  const float4 m = *reinterpret_cast<const float4*>(p);
  d[0] = clip_len(p[-1]);
  d[1] = clip_len(m.x);
  d[2] = clip_len(m.y);
  d[3] = clip_len(m.z);
  d[4] = clip_len(m.w);
  d[5] = clip_len(p[4]);
}

template <bool kVec>
__device__ __forceinline__ void compute_item(const float* win, uint8_t* __restrict__ out,
                                             Item it, int R, int H, int W, float sharpen) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = min(R, H - it.y0);  // valid rows of this band
  const int per = (rows + kWarps - 1) / kWarps;
  const int j0 = warp * per, j1 = min(j0 + per, rows);
  const int x = it.x0 + 4 * lane;
  if (x >= W) return;
  uint8_t* ob = out + ((size_t)it.c * H + it.y0) * W + x;
  float a[6], b[6], s[6];
  if (j0 < j1) {
    load_row(a, win, j0, lane);  // window row j = band row j - 1
    load_row(b, win, j0 + 1, lane);
  }
  for (int j = j0; j < j1; ++j) {
    load_row(s, win, j + 2, lane);
    uint8_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = cas_pixel(a[e], a[e + 1], a[e + 2], b[e], b[e + 1], b[e + 2],
                       s[e], s[e + 1], s[e + 2], sharpen);
    }
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
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      a[e] = b[e];
      b[e] = s[e];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cas_mono_kernel(const float* __restrict__ v, uint8_t* __restrict__ out, int H, int W,
                int R, int nbands, int nstrips, int total, float sharpen) {
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
    compute_item<kVec>(cur, out, item_of(g, nbands, nstrips, R), R, H, W, sharpen);
    __syncthreads();  // no refill of `cur` (next iteration) while it is read
  }
}

}  // namespace

// C entry point (loaded with ctypes).  v: contiguous (C, H, W) float32;
// out: contiguous (C, H, W) uint8; bh: rows per band (capped at H and
// kMaxBand).  One launch of at most (SMs x resident blocks per SM) blocks
// on `stream`; does not synchronise; returns the first cudaError_t of the
// set-up calls and the launch.
extern "C" int vkr_cas_mono(const void* v, void* out, int C, int H, int W, int bh,
                            float sharpen, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0 || bh <= 0) return (int)cudaErrorInvalidValue;
  const int R = min(min(bh, H), kMaxBand);
  const int nbands = 1 + (H - 1) / R, nstrips = 1 + (W - 1) / kStrip;
  const long long total = (long long)C * nbands * nstrips;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(R + 2) * kPitch * sizeof(float);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  void (*kern)(const float*, uint8_t*, int, int, int, int, int, int, float) =
      vec ? cas_mono_kernel<true> : cas_mono_kernel<false>;
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
      (int)total, sharpen);
  return (int)cudaGetLastError();
}
