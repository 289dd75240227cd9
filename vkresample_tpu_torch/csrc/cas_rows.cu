// Fused row weave + woven CAS + quantize (K5); at u = 1 the woven CAS +
// quantize (K3); at u = 2 with a parity store the rows-parity CAS (K2); and
// a copy-only instance, the copy-quantize probe K10c (Hopper, sm_90a).
//
// Replaces three Pallas kernel families of vkresample_tpu/ops/cas_pallas.py:
// - cas_quantize_rows_u (kernel bodies _rows_kernel and _rows_slots_kernel;
//   stencil math _cas_band), the integer u >= 3 rows route: entry
//   vkr_cas_rows_u, any u >= 2;
// - cas_quantize_pallas (kernel bodies _cas_kernel and _cas_slots_kernel;
//   the same _cas_band), the routes whose transform emits a woven image
//   (the r2c and c2c chains, fractional factors and u = 1, and -engine
//   xla): entry vkr_cas_woven, the same kernel at u = 1;
// - cas_parity_planes_u2 (kernel body _parity_kernel; stencil math
//   _parity_planes, _cas_core, _cas_blend), the u=2 rows route and every
//   woven u=2 upscale() call: entry vkr_cas_parity_u2, the same kernel at
//   u = 2 writing the woven image's even and odd rows to two planes.
// The fourth entry, vkr_copy_quantize_rows, is the port's third form of
// scripts/cas_split.py::copy_quantize (beside copy_quantize.cu's K10a and
// K10b): this kernel's data movement with the CAS taken out.
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
// never reads).  At u = 2, K2 takes U and the odd rows O, each (C, h, W),
// and writes woven row 2t to E[c, t] and row 2t+1 to D[c, t], each (C, h,
// W) uint8, so neither woven image exists in device memory.  K10c reads a
// float32 (C, H, W) image at u = 1 through the same staging and register
// walk, raw (no L), and writes quantize_u8 of each centre value where the
// CAS kernel evaluates cas_pixel.
//
// Bound on this card.  About 40 flops per output pixel against 2-4 bytes
// read and 1 written: device memory bounds it.  At both route shapes,
// 1280x720 -> 3840x2160 (u=3: U (3, 720, 3840) + O (3, 1440, 3840)) and
// 960x540 -> 3840x2160 (u=4: U (3, 540, 3840) + O (3, 1620, 3840)), it
// reads U + O once, 49.8 MB of int16 (99.5 MB of float32), and writes 24.9
// MB of uint8: 22.3 us (int16) and 37.1 us (float32) at 3.35 TB/s.  K3 at
// 1920x1080 -> 3840x2160 (-engine xla), (3, 2160, 3840), reads and writes
// the same bytes: the same bounds.  K2 on the rows route 1440x1080 ->
// 2880x2160, U and O (3, 1080, 2880), reads 37.3 MB of int16 (74.6 MB of
// float32) and writes 18.7 MB: 16.7 us (27.9 us float32); on the woven
// flagship 2048x1024 -> 4096x2048, U and O (3, 1024, 4096), 50.3 MB read
// and 25.2 MB written: 22.5 us int16 (37.6 us float32).
//
// What held the first designs back.  K3's and K2's first kernels staged a
// float window, one scalar 2- or 4-byte load per element with a clamp per
// element (K5's first through a row pointer read from a shared-memory
// table; K3's a 32 x 16 tile, K2's a 32 x 8 tile of plane rows holding
// both parities), and then every output read its 9 neighbours from shared
// memory and left as a byte store.  So they were bound by instructions,
// not bytes: K5 took 0.1477 ms int16 against float32's 0.1498 at u=3, K3
// 0.1366 against 0.1387, K2 0.1013 against 0.1037, though int16 reads half
// the bytes.
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
//   % kLane == 0 and the output planes are 4-byte aligned, else byte stores
//   masked at W.  The store form is a template parameter (Form): the woven
//   image (K5, K3, K10c), or K2's parity planes.  A thread's run starts at
//   an even woven row (y0 is a multiple of kBand, its offset one of kRun),
//   so at u = 2 its rows go to E, D, E, D, ... at compile-time indices of
//   the unrolled run, and its plane row steps once every two woven rows.
//   K10c's Form enters values raw and quantizes the centre; the dead west,
//   east and north registers drop out, the staging and the row loads stay.
// - One copy stage per block, and several resident blocks per SM, so that
//   one block's copies overlap another's arithmetic (K4's and K7's lesson).
//   kStrip = 128 (one warp across a row), kBand = 64 rows (8 warps x kRun =
//   8 rows; 3 % halo rows); the window takes 19.0 KB (int16) or 35.9 KB
//   (float32).  Registers per -Xptxas -v, no spill in any instance: the
//   woven form (K5, K3) 40 (int16) / 42 (float32), 6 and 5 blocks of 256
//   threads per SM by registers; the parity form (K2) 48 / 46, 5 blocks:
//   a template parameter leaves the woven instances as they were, where a
//   run-time store branch would have widened them; the copy form (K10c,
//   float32) 26.
//
// The output equals weave_rows + the woven CAS (this kernel at u = 1) on
// every pixel: the same L values reach the same cas_pixel, for any u >= 1
// and h, W >= 1; K2's planes are that image's even and odd rows.
// The TPU kernel's band/slot DMA schedules and its W % 128 weave fallback
// have no counterpart here.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).  K5 at u=3,
// chip_smoke.py phase 6: 0.0903 ms int16, 0.0945 float32 (50 wrapper
// calls); 0.0876 / 0.0919 on the device alone (a CUDA graph); u=4 the same
// within 0.001.  About 4x / 2.5x the bound: int16 is under float32, but
// only by 5 %, so the per-output cas_pixel, not the bytes, sets the time.
// Variants, each changing one constexpr, K5's device time on the routes by
// scripts/torch_route_profile.py (two readings each, int16 u=3 / float32
// u=3 / int16 u=4, ms): this design 0.0863-0.0870 / 0.0931-0.0937 /
// 0.0866-0.0878; kBand = 32 0.0876-0.0884 / 0.0931-0.0941 / 0.0879-0.0885;
// kLane = 8 (56 registers) 0.0851-0.0856 / 0.0919 / 0.0852-0.0858, 1.5 %
// faster for 14 more registers a thread, not taken; a register cut to 6
// blocks per SM (40 registers) the same as this design, to 8 blocks (32
// registers, 36 bytes spilled) 0.0875-0.0878 / 0.0947 / 0.0876.  Before
// the halo chunks, with the int16 halo columns copied through registers (a
// global load each warp waited for in every window row), int16 took 0.0965
// against float32's 0.0879-0.0913; in that build kBand = 128 took 0.101,
// kStrip = 64 0.126-0.128 and 128 threads 0.111 (int16 u=3).  K3 at u = 1, (3, 2160, 3840):
// 0.0853-0.0858 ms int16, 0.0901-0.0910 float32 on the device alone
// (scripts/torch_cas_kernels.py), beside K5 at u=3 on as many outputs,
// 0.0871-0.0875 / 0.0916-0.0925: the division per window row costs nothing
// measurable at u = 1.  K2 at u = 2 (scripts/torch_cas_kernels.py and
// chip_smoke.py phase 6, the device alone, the first kernel's same-call
// readings beside): the rows route's 2 x (3, 1080, 2880) 0.0665-0.0743 ms
// int16 (0.0983-0.0990 before), 0.0706-0.0713 float32 (0.1002-0.1008);
// the woven flagship's 2 x (3, 1024, 4096) 0.0872-0.0882 (0.1315-0.1322),
// 0.0922-0.0930 (0.1340-0.1351), at K5's rate per output; eager 0.002-0.004
// above.  K10c at (3, 2048, 4096) float32 0.0525-0.0527 ms beside K3's
// 0.0919-0.0921 (scripts/torch_cas_split.py): this kernel's data movement
// takes 57 % of K3's time and cas_pixel the other 43 %, 1.4x the bound
// (37.6 us) for the movement alone.
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
static_assert(kRun % 2 == 0 && kBand % 2 == 0, "a thread's run must start at an even woven row");

// What the kernel writes: the CAS of the woven image to the woven uint8
// image (K5, K3), the same to its even and odd rows as two planes (K2, u =
// 2), or the quantized raw centre values to the woven uint8 image (K10c).
enum class Form { kWoven, kParity, kCopy };

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

// A stored value as it goes into registers: its L value, or (kRaw, the
// copy probe) the float32 value itself.
template <bool kRaw, typename T>
__device__ __forceinline__ float enter(T v) {
  if constexpr (kRaw) {
    return v;
  } else {
    return clip_len(v);
  }
}

// The kLane+2 values of one window row around a thread's columns x ..
// x+kLane-1: v[1 + e] is column x+e, v[0] the west neighbour, v[kLane+1]
// the east one.  row: the window row, offset to the thread's first column.
// At x = 0 the west neighbour is column 0; where the columns reach W,
// column W-1 repeats east of it.
template <bool kRaw, typename T>
__device__ __forceinline__ void load_row(float (&v)[kN], const T* row, int x, int W) {
#pragma unroll
  for (int e = 0; e < kLane; e += 4) {
    float d[4];
    if constexpr (kRaw) {
      const float4 m = *reinterpret_cast<const float4*>(row + e);
      d[0] = m.x;
      d[1] = m.y;
      d[2] = m.z;
      d[3] = m.w;
    } else {
      load4(d, row + e);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[1 + e + i] = d[i];
  }
  v[0] = enter<kRaw>(row[-1]);
  v[kLane + 1] = enter<kRaw>(row[kLane]);
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

// out: the woven (C, u*h, W) uint8 image, or with Form::kParity the even-row
// plane E (C, h, W) and out_odd the odd-row plane D (unused otherwise).
template <typename T, Form F>
__global__ void __launch_bounds__(kThreads)
cas_rows_kernel(const T* __restrict__ U, const T* __restrict__ O, uint8_t* __restrict__ out,
                uint8_t* __restrict__ out_odd, int h, int W, int u, int vec, int store_wide,
                float sharpen) {
  using Win = Window<T>;
  constexpr bool kRaw = F == Form::kCopy;
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

  // the thread's columns x .. x+kLane-1 and woven rows y .. y+kRun-1 (y even)
  const int g = threadIdx.x % kGroups, j = threadIdx.x / kGroups * kRun;
  const int x = x0 + kLane * g, y = y0 + j;
  if (x >= W || y >= H) return;
  // window row j holds woven row y-1
  const T* row = win + j * Win::kPitch + Win::kLeft + kLane * g;
  float a[kN], b[kN], n[kN];
  load_row<kRaw>(a, row, x, W);
  load_row<kRaw>(b, row + Win::kPitch, x, W);
  // woven row y's first byte; with Form::kParity row y >> 1 of E, and of D
  // for the odd rows
  const size_t first = F == Form::kParity ? (c * h + (y >> 1)) * (size_t)W + x
                                          : (c * H + y) * (size_t)W + x;
  uint8_t* dst = out + first;
  uint8_t* dst_odd = F == Form::kParity ? out_odd + first : nullptr;
  const int rows = min(kRun, H - y);
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (i < rows) {
      load_row<kRaw>(n, row + (i + 2) * Win::kPitch, x, W);
      uint8_t ob[kLane];
#pragma unroll
      for (int e = 0; e < kLane; ++e) {
        if constexpr (kRaw) {
          ob[e] = quantize_u8(b[e + 1]);
        } else {
          ob[e] = cas_pixel(a[e], a[e + 1], a[e + 2], b[e], b[e + 1], b[e + 2], n[e],
                            n[e + 1], n[e + 2], sharpen);
        }
      }
      uint8_t* d = F == Form::kParity && (i & 1) ? dst_odd : dst;
      if (store_wide) {
#pragma unroll
        for (int e = 0; e < kLane; e += 4) {
          *reinterpret_cast<uint32_t*>(d + e) = pack4(ob + e);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kLane; ++e) {
          if (x + e < W) d[e] = ob[e];
        }
      }
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        a[q] = b[q];
        b[q] = n[q];
      }
      if (F != Form::kParity) {
        dst += W;
      } else if (i & 1) {  // after the odd row: the next plane row of E and D
        dst += W;
        dst_odd += W;
      }
    }
  }
}

template <Form F, typename T>
int launch(const T* U, const T* O, uint8_t* out, uint8_t* out_odd, int C, int h, int W, int u,
           float sharpen, cudaStream_t st) {
  const bool vec = W % Window<T>::kVec == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(O) % 16 == 0;
  const bool store_wide = W % kLane == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(out_odd) % 4 == 0;
  const dim3 grid((W + kStrip - 1) / kStrip, (u * h + kBand - 1) / kBand, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cas_rows_kernel<T, F><<<grid, kThreads, 0, st>>>(U, O, out, out_odd, h, W, u, (int)vec,
                                                   (int)store_wide, sharpen);
  return (int)cudaGetLastError();
}

// The launch of a CAS entry, checked entry-side: U and O of one dtype
// (is_i16: int16 Q2.14, else float32); out_odd: D for Form::kParity, else
// out again.
template <Form F>
int launch_dtype(const void* U, const void* O, void* out, void* out_odd, int C, int h, int W,
                 int u, int is_i16, float sharpen, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  uint8_t* od = static_cast<uint8_t*>(out_odd);
  if (is_i16) {
    return launch<F>(static_cast<const int16_t*>(U), static_cast<const int16_t*>(O), o, od, C,
                     h, W, u, sharpen, st);
  }
  return launch<F>(static_cast<const float*>(U), static_cast<const float*>(O), o, od, C, h, W,
                   u, sharpen, st);
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
  return launch_dtype<Form::kWoven>(U, O, out, out, C, h, W, u, is_i16, sharpen, stream);
}

// K3.  v: contiguous (C, H, W) of one dtype (is_i16: int16 Q2.14, else
// float32); out: contiguous (C, H, W) uint8; any C, H, W >= 1.  The kernel
// at u = 1, with v as U and as O: it never reads O there, and the 16-byte
// staging test then depends on v alone.
extern "C" int vkr_cas_woven(const void* v, void* out, int C, int H, int W,
                             int is_i16, float sharpen, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return launch_dtype<Form::kWoven>(v, v, out, out, C, H, W, 1, is_i16, sharpen, stream);
}

// K2.  U, O: contiguous (C, h, W) of one dtype (is_i16: int16 Q2.14, else
// float32), the sample rows and the odd rows; E, D: contiguous (C, h, W)
// uint8, the woven CAS image's even and odd rows; any C, h, W >= 1.  The
// kernel at u = 2 with the parity store; 32-bit stores need both E and D
// 4-byte aligned.
extern "C" int vkr_cas_parity_u2(const void* U, const void* O, void* E, void* D,
                                 int C, int h, int W, int is_i16,
                                 float sharpen, void* stream) {
  if (C <= 0 || h <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (2LL * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch_dtype<Form::kParity>(U, O, E, D, C, h, W, 2, is_i16, sharpen, stream);
}

// K10c.  v: contiguous (C, H, W) float32; out: contiguous (C, H, W) uint8,
// quantize_u8(v); any C, H, W >= 1.  The kernel's copy-only instance at
// u = 1, with v as U and as O (never read there).
extern "C" int vkr_copy_quantize_rows(const void* v, void* out, int C, int H, int W,
                                      void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(v);
  uint8_t* o = static_cast<uint8_t*>(out);
  return launch<Form::kCopy>(f, f, o, o, C, H, W, 1, 0.0f, static_cast<cudaStream_t>(stream));
}
