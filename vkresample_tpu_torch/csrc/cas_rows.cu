// Fused row weave + woven CAS + quantize (K5), and at u = 1 the woven CAS +
// quantize (K3) (Hopper, sm_90a).
//
// Replaces two Pallas kernel families of vkresample_tpu/ops/cas_pallas.py:
// - cas_quantize_rows_u (kernel bodies _rows_kernel and _rows_slots_kernel;
//   stencil math _cas_band), the integer u >= 3 rows route: entry
//   vkr_cas_rows_u, any u >= 2;
// - cas_quantize_pallas (kernel bodies _cas_kernel and _cas_slots_kernel;
//   the same _cas_band), the routes whose transform emits a woven image
//   (the r2c and c2c chains, fractional factors and u = 1, and -engine
//   xla): entry vkr_cas_woven, the same kernel at u = 1.
//
// What it computes.  The row-split transform hands over the sample output
// rows U (C, h, W) and the non-sample rows O (C, h*(u-1), W), both int16
// Q2.14 (x 1/16384) or both float32, with O[t*(u-1) + k] = out[u*t + k + 1].
// They are the woven image V[c, u*t] = U[c, t], V[c, u*t + k + 1] =
// O[c, t*(u-1) + k] of size (C, u*h, W).  Every output pixel is the 3x3
// clamp-to-edge CAS of L = min(|V|, 1) (cas_common.cuh::cas_pixel), written
// to the woven uint8 image (C, u*h, W).  The woven pre-CAS image never
// exists in device memory: the route's two passes, a row weave then the
// woven CAS, become one.  At u = 1 there are no non-sample rows: V is U
// itself, any (C, H, W) image already in CAS units, and the kernel is the
// plain woven CAS (vkr_cas_woven passes the image as U and as O, which it
// never reads).
//
// Bound on this card.  About 40 flops per output pixel against 2-4 bytes
// read and 1 written: device memory bounds it.  At both route shapes,
// 1280x720 -> 3840x2160 (u=3: U (3, 720, 3840) + O (3, 1440, 3840)) and
// 960x540 -> 3840x2160 (u=4: U (3, 540, 3840) + O (3, 1620, 3840)), it
// reads U + O once, 49.8 MB of int16 (99.5 MB of float32), and writes 24.9
// MB of uint8: 22.3 us (int16) and 37.1 us (float32) at 3.35 TB/s.
//
// K3 at 1920x1080 -> 3840x2160 (-engine xla), (3, 2160, 3840), reads and
// writes the same bytes: the same bounds.
//
// What held the first design back.  It was the woven CAS's first tile,
// which K3 kept until it moved here: a block of 32 columns x 16 woven rows
// staged its (16+2) x (32+2) window as float, one scalar 2- or 4-byte load
// per element (K5's through a row pointer read from a shared-memory
// table), with a column clamp per element and every row's loads starting
// one column left of the strip; then every output read its 9 neighbours
// from shared memory and left as a byte store.  So it was bound by
// instructions, not bytes: K5 took 0.1477 ms int16 against float32's
// 0.1498 at u=3, K3 0.1366 against 0.1387, though int16 reads half the
// bytes.
//
// Design.
// - A block takes the work item (channel, band of kBand woven rows, strip
//   of kStrip columns) and copies its (kBand+2) x (kStrip+2) window (one
//   halo row and column on each side) from U and O into shared memory as
//   the stored dtype.  Where W * sizeof(T) % 16 == 0 and U and O are
//   16-byte aligned, every copy is a 16-byte cp.async (8 int16 or 4
//   float32): the strip's chunks and the whole chunk on each side of it,
//   which holds the halo column; else per-element copies, 2-byte register
//   loads (int16) or 4-byte cp.async (float32).  Which form runs is a
//   branch that is the same for every block, so each dtype is one kernel
//   instance.  Each warp copies whole window rows: the woven row index Y is
//   clamped to [0, u*h-1] (row -1 is woven row 0, U's first row; row u*h
//   is woven row u*h-1, O's last) and split into (t, k) = (Y / u, Y % u),
//   U[t] for k == 0 and O[t*(u-1) + k-1] otherwise, once per window row,
//   so u stays a run-time argument (every u >= 1 runs) at one division per
//   row; at u = 1 every row is U[Y].  Window rows past the halo of the last
//   woven row and columns past W are not copied.
// - Each thread owns kLane = 4 adjacent columns and walks down a run of
//   kRun woven rows, keeping three rows of kLane+2 L values in registers:
//   each row step is one 8- or 16-byte shared load plus the west and east
//   neighbours for kLane outputs (9 shared loads per output before).  L =
//   min(|v|, 1) is taken as a value goes into registers.  At column 0 the
//   west neighbour is column 0; where a thread's columns reach W, column
//   W-1 repeats east of it.
// - Each thread writes its kLane bytes of a row as one 32-bit store where W
//   % kLane == 0 and out is 4-byte aligned, else byte stores masked at W.
// - One copy stage per block, and several resident blocks per SM (42
//   registers, no spill, per -Xptxas -v: 5 blocks of 256 threads), so that
//   one block's copies overlap another's arithmetic (K4's and K7's lesson).
//   kStrip = 128 (one warp across a row), kBand = 64 rows (8 warps x kRun =
//   8 rows; 3 % halo rows); the window takes 19.0 KB (int16) or 35.9 KB
//   (float32).
//
// The output equals weave_rows + the woven CAS (this kernel at u = 1) on
// every pixel: the same L values reach the same cas_pixel, for any u >= 1
// and h, W >= 1.
// The TPU kernel's band/slot DMA schedules and its W % 128 weave fallback
// have no counterpart here.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).  chip_smoke.py
// phase 6 at u=3: 0.0903 ms int16, 0.0945 float32 (50 wrapper calls);
// 0.0876 / 0.0919 on the device alone (a CUDA graph); u=4 the same within
// 0.001.  The first design read 0.1477 / 0.1498 by the first method (PERF.md
// holds both designs read in one call).  About 4x / 2.5x the bound: int16
// is now under float32, but only by 5 %, so the per-output cas_pixel, not
// the bytes, sets the time.  Variants, each changing one constexpr,
// K5's device time on the routes by scripts/torch_route_profile.py (two
// readings each, int16 u=3 / float32 u=3 / int16 u=4, ms): this design
// 0.0863-0.0870 / 0.0931-0.0937 / 0.0866-0.0878; kBand = 32 0.0876-0.0884 /
// 0.0931-0.0941 / 0.0879-0.0885; kLane = 8 (56 registers) 0.0851-0.0856 /
// 0.0919 / 0.0852-0.0858, 1.5 % faster for 14 more registers a thread, not
// taken; a register cut to 6 blocks per SM (40 registers) the same as this
// design, to 8 blocks (32 registers, 36 bytes spilled) 0.0875-0.0878 /
// 0.0947 / 0.0876.  Before the halo chunks, with the int16 halo columns
// copied through registers (a global load each warp waited for in every
// window row), int16 took 0.0965 against float32's 0.0879-0.0913; in that
// build kBand = 128 took 0.101, kStrip = 64 0.126-0.128 and 128 threads
// 0.111 (int16 u=3).  K3 at u = 1, (3, 2160, 3840): 0.0853-0.0858 ms int16,
// 0.0901-0.0910 float32 on the device alone (scripts/torch_cas_kernels.py,
// chip_smoke.py phase 6), beside K5 at u=3 on as many outputs in the same
// calls, 0.0871-0.0875 / 0.0916-0.0925, and the old K3 tile's 0.1336-0.1352
// / 0.1362-0.1396: the division per window row costs nothing measurable at
// u = 1, so there is no single-source instance.
#include "cas_common.cuh"

namespace {

constexpr int kStrip = 128;   // columns per work item
constexpr int kLane = 4;      // adjacent columns per thread
constexpr int kBand = 64;     // woven rows per work item
constexpr int kThreads = 256;
constexpr int kGroups = kStrip / kLane;            // threads along a row
constexpr int kRun = kBand / (kThreads / kGroups);  // woven rows per thread
constexpr int kN = kLane + 2;                      // L values of a row in registers
static_assert(kLane % 4 == 0 && kStrip % kLane == 0 && kThreads % kGroups == 0 &&
              kBand % (kThreads / kGroups) == 0, "inconsistent work item shape");

// A window in shared memory: kBand+2 rows of kPitch elements; window column
// kLeft + x holds strip column x (x = -1 .. kStrip), so the interior starts
// 16 bytes into the row and every row starts 16-byte aligned.
template <typename T>
struct Window {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kLeft = kVec;
  static constexpr int kPitch = kStrip + 2 * kLeft;
  static constexpr int kRows = kBand + 2;
};

// Start the copies of work item (channel c, woven rows y0-1 .. y0+kBand,
// columns x0-1 .. x0+kStrip) into win, one window row per warp at a time:
// kVec, 16-byte copies of the strip's chunks and of the chunk on each side
// of it, which holds the halo column (window columns 0 .. kPitch-1); else
// per-element copies of columns x0-1 .. x0+kStrip.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_copies(T* win, const T* U, const T* O, size_t c, int h,
                                             int u, int W, int y0, int x0) {
  using Win = Window<T>;
  constexpr int kChunks = kStrip / Win::kVec;  // 16-byte copies per window row
  constexpr int kPerRow = kVec ? kChunks + 2 : kStrip + 2;
  const int H = u * h, lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < Win::kRows; r += kThreads / 32) {
    const int Y = y0 - 1 + r;
    if (Y > H) break;  // past the halo of woven row H-1: read by nothing
    const int Yc = min(max(Y, 0), H - 1);
    const int t = Yc / u, k = Yc - t * u;
    const T* src = k == 0 ? U + (c * h + t) * (size_t)W
                          : O + ((c * h + t) * (u - 1) + (k - 1)) * (size_t)W;
    T* dst = win + r * Win::kPitch + Win::kLeft;
    for (int q = lane; q < kPerRow; q += 32) {
      if (kVec) {
        // chunk q-1 (W % kVec == 0: a chunk is all in or all out)
        const int x = x0 + (q - 1) * Win::kVec;
        if (x >= 0 && x < W) cp_async16(dst + (q - 1) * Win::kVec, src + x);
      } else {
        const int x = x0 + q - 1;  // clamped at column 0
        if (x < W) copy_elem(dst + q - 1, src + max(x, 0));
      }
    }
  }
}

// The kLane+2 L values of one window row around a thread's columns x ..
// x+kLane-1: v[1 + e] is column x+e, v[0] the west neighbour, v[kLane+1]
// the east one.  row: the window row, offset to the thread's first column.
// At x = 0 the west neighbour is column 0; where the columns reach W,
// column W-1 repeats east of it.
template <typename T>
__device__ __forceinline__ void load_row(float (&v)[kN], const T* row, int x, int W) {
#pragma unroll
  for (int e = 0; e < kLane; e += 4) {
    float d[4];
    load4(d, row + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[1 + e + i] = d[i];
  }
  v[0] = clip_len(row[-1]);
  v[kLane + 1] = clip_len(row[kLane]);
  if (x == 0) v[0] = v[1];
  if (x + kLane >= W) {
    const int nv = W - x;  // valid columns of the thread, 1..kLane
    float edge = v[1];
#pragma unroll
    for (int e = 2; e <= kLane; ++e) {
      if (nv >= e) edge = v[e];
    }
#pragma unroll
    for (int q = 2; q < kN; ++q) {
      if (q > nv) v[q] = edge;
    }
  }
}

__device__ __forceinline__ uint32_t pack4(const uint8_t* b) {
  return b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cas_rows_kernel(const T* __restrict__ U, const T* __restrict__ O, uint8_t* __restrict__ out,
                int h, int W, int u, int vec, int store_wide, float sharpen) {
  using Win = Window<T>;
  __shared__ __align__(16) T win[Win::kRows * Win::kPitch];
  const int H = u * h;
  const size_t c = blockIdx.z;
  const int y0 = blockIdx.y * kBand, x0 = blockIdx.x * kStrip;
  if (vec) {
    stage_copies<T, true>(win, U, O, c, h, u, W, y0, x0);
  } else {
    stage_copies<T, false>(win, U, O, c, h, u, W, y0, x0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // the thread's columns x .. x+kLane-1 and woven rows y .. y+kRun-1
  const int g = threadIdx.x % kGroups, j = threadIdx.x / kGroups * kRun;
  const int x = x0 + kLane * g, y = y0 + j;
  if (x >= W || y >= H) return;
  // window row j holds woven row y-1
  const T* row = win + j * Win::kPitch + Win::kLeft + kLane * g;
  float a[kN], b[kN], n[kN];
  load_row(a, row, x, W);
  load_row(b, row + Win::kPitch, x, W);
  uint8_t* dst = out + (c * H + y) * (size_t)W + x;
  const int rows = min(kRun, H - y);
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (i < rows) {
      load_row(n, row + (i + 2) * Win::kPitch, x, W);
      uint8_t ob[kLane];
#pragma unroll
      for (int e = 0; e < kLane; ++e) {
        ob[e] = cas_pixel(a[e], a[e + 1], a[e + 2], b[e], b[e + 1], b[e + 2], n[e], n[e + 1],
                          n[e + 2], sharpen);
      }
      if (store_wide) {
#pragma unroll
        for (int e = 0; e < kLane; e += 4) {
          *reinterpret_cast<uint32_t*>(dst + e) = pack4(ob + e);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kLane; ++e) {
          if (x + e < W) dst[e] = ob[e];
        }
      }
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        a[q] = b[q];
        b[q] = n[q];
      }
      dst += W;
    }
  }
}

template <typename T>
int launch(const T* U, const T* O, uint8_t* out, int C, int h, int W, int u, float sharpen,
           cudaStream_t st) {
  const bool vec = W % Window<T>::kVec == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(O) % 16 == 0;
  const bool store_wide = W % kLane == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid((W + kStrip - 1) / kStrip, (u * h + kBand - 1) / kBand, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cas_rows_kernel<T><<<grid, kThreads, 0, st>>>(U, O, out, h, W, u, (int)vec, (int)store_wide,
                                                sharpen);
  return (int)cudaGetLastError();
}

// The launch of either entry, checked entry-side: U and O of one dtype
// (is_i16: int16 Q2.14, else float32).
int launch_dtype(const void* U, const void* O, void* out, int C, int h, int W, int u,
                 int is_i16, float sharpen, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_i16) {
    return launch(static_cast<const int16_t*>(U), static_cast<const int16_t*>(O), o, C, h, W,
                  u, sharpen, st);
  }
  return launch(static_cast<const float*>(U), static_cast<const float*>(O), o, C, h, W, u,
                sharpen, st);
}

}  // namespace

// C entry points (loaded with ctypes).  Each launches on `stream`, does not
// synchronise and returns the cudaError_t of the launch.
//
// K5.  U: contiguous (C, h, W), O: contiguous (C, h*(u-1), W), one dtype
// (is_i16: int16 Q2.14, else float32); out: contiguous (C, u*h, W) uint8;
// any u >= 2, h, W >= 1 (the JAX cas_quantize_rows_u's u >= 2).
extern "C" int vkr_cas_rows_u(const void* U, const void* O, void* out, int C,
                              int h, int W, int u, int is_i16, float sharpen,
                              void* stream) {
  if (C <= 0 || h <= 0 || W <= 0 || u < 2) return (int)cudaErrorInvalidValue;
  if ((long long)u * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch_dtype(U, O, out, C, h, W, u, is_i16, sharpen, stream);
}

// K3.  v: contiguous (C, H, W) of one dtype (is_i16: int16 Q2.14, else
// float32); out: contiguous (C, H, W) uint8; any C, H, W >= 1.  The kernel
// at u = 1, with v as U and as O: it never reads O there, and the 16-byte
// staging test then depends on v alone.
extern "C" int vkr_cas_woven(const void* v, void* out, int C, int H, int W,
                             int is_i16, float sharpen, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return launch_dtype(v, v, out, C, H, W, 1, is_i16, sharpen, stream);
}
