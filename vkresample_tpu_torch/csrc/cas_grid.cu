// u-generic grid-parity fused CAS + quantize (K4), and at u = 2 the
// quad-parity CAS (K1) (Hopper, sm_90a).
//
// Replaces two Pallas kernel families of vkresample_tpu/ops/cas_pallas.py:
// - cas_parity_grid_planes (stencil math _grid_planes, kernel bodies
//   _grid_strip_kernel and _grid_strip_slots_kernel): entry vkr_cas_grid,
//   any u = 1..8;
// - cas_parity4_planes_u2 (stencil math _quad_planes, _cas_core,
//   _cas_blend; kernel bodies _quad_kernel, _quad_strip_kernel and
//   _quad_strip_slots_kernel), the u=2 quad route (the CLI's route) and the
//   c2c grid at p = 2: entry vkr_cas_quad_u2, the U = 2 instance with the
//   four planes passed as eight pointers.
//
// What it computes.  The transform hands over u*u pre-CAS phase planes
// P[ry][rx] (row-major), each (C, h, W), int16 Q2.14 (x 1/16384) or
// float32.  They are the woven image V[c, u*t+ry, u*s+rx] = P[ry][rx][c, t,
// s] of size (C, u*h, u*W).  With L = min(|V|, 1), every output pixel is
// the 3x3 clamp-to-edge FidelityFX-CAS of L (cas_common.cuh::cas_pixel),
// written back as u*u uint8 planes of the same layout, so the woven image
// exists neither in device memory nor on the host.  u=2 is K1; the c2c grid
// route sends its p >= 3 planes (integer u, or the numerator of p/q) to
// vkr_cas_grid.
//
// Bound on this card.  About 40 flops per output pixel against 2-4 bytes
// read and 1 written: device memory bounds it.  At 1280x720 -> 3840x2160
// (u=3, nine (3, 720, 1280) planes) it reads 49.8 MB of int16 (99.5 MB of
// float32) and writes 24.9 MB: 22.3 us (int16) and 37.1 us (float32) at
// 3.35 TB/s; at 1280x720 -> 1920x1080 (nine (3, 360, 640) planes) a
// quarter of that.  K1 at the flagship 2048x1024 -> 4096x2048 (four (3,
// 1024, 2048) planes) reads 50.3 MB of int16 (100.7 MB of float32) and
// writes 25.2 MB: 22.5 us (int16) and 37.6 us (float32).
//
// What held the first design back.  It staged the woven (8u+2) x (32u+2)
// halo tile as float, one scalar load per element, each with a division by
// the runtime tile width, a division and modulo by the runtime u, and a
// plane pointer taken by a runtime index; then every output read its 9
// neighbours from shared memory (81 shared loads per thread at u=3) in
// loops over a runtime u that did not unroll, and went out as a byte store.
// So it was bound by instructions, not bytes: int16 took 0.2109 ms against
// float32's 0.1824 at 9 x (3, 720, 1280), though it reads half the bytes.
// K1 had its own kernel of that kind until it moved here: a 32 x 8 block
// staged the woven 18 x 66 float window, one scalar load per element with
// a parity decode and a row and column clamp, and wrote byte stores to the
// four planes (0.1267 ms int16, 0.1310 float32 at four (3, 1024, 2048)
// planes).
//
// Design.
// - u is a template parameter (U = 1..8, dispatched by a switch in the
//   entry point), so every division by U or by a window size is a
//   multiply-shift, the loops over the phases (ry, rx) unroll and the
//   output plane pointers are compile-time indices of the argument struct
//   (a __grid_constant__ parameter, so the staging loop's runtime index
//   into the input pointers is a constant-bank load, not a local copy).
// - A block takes the work item (channel, band of R plane rows, strip of
//   kStrip = 64 plane columns) and stages, for each of the U*U planes, the
//   (R+2) x (64+2) window of that plane (one halo row and column on each
//   side, at clamped plane addresses) into shared memory as the stored
//   dtype: 16-byte cp.async copies (8 int16 or 4 float32) where W *
//   sizeof(T) % 16 == 0 and every input plane is 16-byte aligned, else
//   2-byte loads (int16) or 4-byte cp.async copies (float32) per element.
//   Which form runs is a branch that is the same for every block, so each
//   (U, dtype) is one kernel instance.  Int16 takes half the shared memory
//   and half the copies of float32.  L = min(|v|, 1) is taken when a value
//   goes into registers.
// - Each thread owns 4 adjacent plane columns of one plane row t.  For each
//   woven row it needs, it reads the 4U+2 woven values around its columns
//   from the U windows of that phase row (one 8- or 16-byte shared load per
//   phase plus the west and east neighbours) into registers, and walks down
//   the U+2 woven rows u*t-1 .. u*t+U keeping three rows in registers:
//   each row step evaluates the U x 4 outputs of one woven row (U+2 row
//   loads for 4U^2 outputs).
// - The woven border is not a per-plane clamp.  Woven row -1 clamps to
//   woven row 0, which is phase row 0 itself, not the clamped plane row of
//   phase U-1; woven row u*h to phase row U-1 at plane row h-1; the same
//   for columns (cas_pallas.py:2203-2214 says so for the JAX pad route).
//   So at t = 0 the row above comes from phase row 0 of the clamped window
//   row (plane row 0), at t = h-1 the row below from phase row U-1; a
//   thread at column 0 takes woven column 0 as its west neighbour, and a
//   thread whose 4 columns reach W repeats woven column u*W-1 to the east.
//   Window cells past the edge that nothing valid reads are not copied.
// - Each of the U*U output planes gets the thread's 4 bytes as one 32-bit
//   store where W % 4 == 0 and every output plane is 4-byte aligned, else
//   byte stores masked at W.
// - Rows per band, threads per block and the register budget are constexpr
//   per U (and dtype), chosen on the card from builds of this file that
//   changed one of them at a time, K4 timed alone at its route shapes: R =
//   16 with 256 threads for U <= 3 (window 25.9 KB int16, 46.7 KB float32
//   at U=3; R = 8 was slower at 720p), int16 with registers cut for 4
//   resident blocks per SM (64 a thread, a few bytes spilled; the ~76 it
//   takes uncut leave 3 and were slower), float32 uncut (cut, it was
//   slower); R = 8 with 128 threads at U = 4 (25.6 / 46.1 KB; 5 blocks, no
//   spill); R = 4 with 64 threads for U >= 5 (at most 110.6 KB float32 at
//   U=8), whose phase-row loop is not unrolled, which keeps the build
//   short.  Several resident blocks per SM let one block's copies overlap
//   another's arithmetic.  Every h, W >= 1 runs; neither the TPU kernel's
//   band/strip DMA variants, its VMEM budget, its replicate-pad reroute nor
//   its woven fallback have a counterpart here.
//
// Measured (PERF.md, K4; chip_smoke.py phase 6 and
// scripts/torch_route_profile.py): about twice as fast as the first design
// on the card's own time at the u=3 route shapes and still some 4x the
// bound.  What is left is mostly the per-output CAS evaluation (cas_pixel's
// min/max tree, rsqrt, IEEE divide and truncating convert), which the
// copies of other resident blocks hide only in part.  K1 on the U = 2
// instance (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): four (3, 1024,
// 2048) planes take 0.0884-0.0890 ms int16 and 0.0891-0.0898 float32 on the
// device alone (scripts/torch_cas_kernels.py, chip_smoke.py phase 6), the
// old quad kernel 0.1230-0.1245 / 0.1267-0.1281 in the same calls; per
// output that is no slower than U = 3 at its route shape (0.0890 for 24.9
// M outputs), so U = 2 keeps the U <= 3 constexprs (59 / 60 registers, no
// spill, per -Xptxas -v).
#include "cas_common.cuh"

namespace {

constexpr int kMaxU = 8;     // largest phase count (64 planes)
constexpr int kStrip = 64;   // plane columns per work item
constexpr int kLane = 4;     // adjacent plane columns per thread
constexpr int kGroups = kStrip / kLane;  // threads along a plane row

struct GridPlanes {
  const void* in[kMaxU * kMaxU];
  uint8_t* out[kMaxU * kMaxU];
};

// Rows per band (one plane row per thread) and threads per block, per
// phase count U.
template <int U>
struct GridShape {
  static constexpr int kRows = U <= 3 ? 16 : (U == 4 ? 8 : 4);
  static constexpr int kThreads = kRows * kGroups;
};

// The resident blocks per SM the register budget is cut for (1: not cut).
template <int U, typename T>
constexpr int kMinBlocks = U <= 3 ? (sizeof(T) == 2 ? 4 : 1) : (U == 4 ? 5 : 1);

// A plane's window in shared memory: (R+2) rows of kPitch elements; window
// column kLeft + x holds strip column x (x = -1 .. kStrip), so the interior
// starts 16 bytes into the row and every row starts 16-byte aligned.
template <typename T>
struct Window {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kLeft = kVec;
  static constexpr int kPitch = kStrip + 2 * kLeft;
};

template <int U, typename T>
constexpr size_t window_bytes() {
  return sizeof(T) * (size_t)U * U * (GridShape<U>::kRows + 2) * Window<T>::kPitch;
}

// Start the copies of the windows of work item (channel base cbase, plane
// rows t0-1 .. t0+R, plane columns s0-1 .. s0+kStrip) of all U*U planes
// into win: kVec, 16-byte copies of the interior and per-element halo
// columns; else per-element copies of every column.
template <int U, typename T, bool kVec>
__device__ __forceinline__ void stage_copies(T* win, const GridPlanes& planes, size_t cbase,
                                             int t0, int s0, int h, int W) {
  using G = GridShape<U>;
  using Win = Window<T>;
  constexpr int kChunks = kStrip / Win::kVec;  // 16-byte copies per window row
  constexpr int kPerRow = kVec ? kChunks + 2 : kStrip + 2;
  constexpr int kPerPlane = (G::kRows + 2) * kPerRow;
  for (int k = threadIdx.x; k < U * U * kPerPlane; k += G::kThreads) {
    const int p = k / kPerPlane, rem = k - p * kPerPlane;
    const int r = rem / kPerRow, q = rem - r * kPerRow;
    const T* src = static_cast<const T*>(planes.in[p]) + cbase +
                   (size_t)min(max(t0 - 1 + r, 0), h - 1) * W;
    T* dst = win + (p * (G::kRows + 2) + r) * Win::kPitch + Win::kLeft;
    if (kVec && q < kChunks) {
      const int x = s0 + q * Win::kVec;  // W % kVec == 0: a chunk is all in or all out
      if (x < W) cp_async16(dst + q * Win::kVec, src + x);
    } else {
      // kVec: the two halo columns (q = kChunks, kChunks + 1); else every
      // column s0 - 1 + q
      const int col = kVec ? (q == kChunks ? -1 : kStrip) : q - 1;
      if (s0 + col < W) copy_elem(dst + col, src + min(max(s0 + col, 0), W - 1));
    }
  }
}

// Stage the work item's windows (vec: the 16-byte form; the same for every
// block, so one kernel instance per U and T holds both forms), then wait
// for every thread's copies.
template <int U, typename T>
__device__ __forceinline__ void stage(T* win, const GridPlanes& planes, size_t cbase, int t0,
                                      int s0, int h, int W, int vec) {
  if (vec) {
    stage_copies<U, T, true>(win, planes, cbase, t0, s0, h, W);
  } else {
    stage_copies<U, T, false>(win, planes, cbase, t0, s0, h, W);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The 4U+2 L values of one woven row around a thread's plane columns s ..
// s+3: v[1 + U*e + rx] is phase rx at column s+e, v[0] the west neighbour
// (phase U-1 at column s-1), v[4U+1] the east one (phase 0 at column s+4).
// row: the phase row's first window (rx = 0) at the window row needed,
// offset to the thread's columns.  Then the woven border: at s = 0 the west
// neighbour is woven column 0; where the columns reach W, woven column u*W-1
// repeats east of it.
template <int U, typename T>
__device__ __forceinline__ void load_row(float (&v)[4 * U + 2], const T* row, int s, int W) {
  constexpr int kPlane = (GridShape<U>::kRows + 2) * Window<T>::kPitch;
#pragma unroll
  for (int rx = 0; rx < U; ++rx) {
    float d[4];
    load4(d, row + rx * kPlane);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[1 + U * e + rx] = d[e];
  }
  v[0] = clip_len(row[(U - 1) * kPlane - 1]);
  v[4 * U + 1] = clip_len(row[kLane]);
  if (s == 0) v[0] = v[1];
  if (s + kLane >= W) {
    const int nv = W - s;  // valid columns of the thread, 1..4
    float edge = v[U];
#pragma unroll
    for (int e = 2; e <= kLane; ++e) {
      if (nv >= e) edge = v[U * e];
    }
#pragma unroll
    for (int q = U + 1; q < 4 * U + 2; ++q) {
      if (q > U * nv) v[q] = edge;
    }
  }
}

template <int U, typename T>
__global__ void __launch_bounds__(GridShape<U>::kThreads, (kMinBlocks<U, T>))
cas_grid_kernel(const __grid_constant__ GridPlanes planes, int h, int W, int vec, int store32,
                float sharpen) {
  using G = GridShape<U>;
  using Win = Window<T>;
  constexpr int kPlane = (G::kRows + 2) * Win::kPitch;
  constexpr int kN = 4 * U + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  const size_t cbase = (size_t)blockIdx.z * (size_t)h * (size_t)W;
  const int t0 = blockIdx.y * G::kRows, s0 = blockIdx.x * kStrip;
  stage<U, T>(win, planes, cbase, t0, s0, h, W, vec);

  const int g = threadIdx.x % kGroups, slot = threadIdx.x / kGroups;
  const int t = t0 + slot, s = s0 + kLane * g;
  if (t >= h || s >= W) return;
  // window row j holds plane row t; phase row ry's first window starts at
  // win + ry * U * kPlane
  const int j = slot + 1;
  const T* col = win + Win::kLeft + kLane * g;
  auto row_at = [&](int ry, int r) { return col + ry * U * kPlane + r * Win::kPitch; };
  float a[kN], b[kN], n[kN];
  load_row<U>(a, row_at(t == 0 ? 0 : U - 1, j - 1), s, W);  // woven row u*t-1
  load_row<U>(b, row_at(0, j), s, W);                       // woven row u*t
  const size_t o = cbase + (size_t)t * W + s;
  // woven row u*t+ry: its outputs from a, b and the row below, n
  auto step = [&](int ry) {
    if (ry + 1 < U) {
      load_row<U>(n, row_at(ry + 1, j), s, W);
    } else {
      load_row<U>(n, row_at(t == h - 1 ? U - 1 : 0, j + 1), s, W);
    }
#pragma unroll
    for (int rx = 0; rx < U; ++rx) {
      uint8_t ob[kLane];
#pragma unroll
      for (int e = 0; e < kLane; ++e) {
        const int q = 1 + U * e + rx;
        ob[e] = cas_pixel(a[q - 1], a[q], a[q + 1], b[q - 1], b[q], b[q + 1], n[q - 1], n[q],
                          n[q + 1], sharpen);
      }
      uint8_t* dst = planes.out[ry * U + rx] + o;
      if (store32) {
        *reinterpret_cast<uint32_t*>(dst) =
            ob[0] | (ob[1] << 8) | (ob[2] << 16) | ((uint32_t)ob[3] << 24);
      } else {
#pragma unroll
        for (int e = 0; e < kLane; ++e) {
          if (s + e < W) dst[e] = ob[e];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      a[q] = b[q];
      b[q] = n[q];
    }
  };
  // the route's U = 3, 4 unroll the phase rows; U >= 5 loop over them,
  // which keeps their build short
  if constexpr (U <= 4) {
#pragma unroll
    for (int ry = 0; ry < U; ++ry) step(ry);
  } else {
#pragma unroll 1
    for (int ry = 0; ry < U; ++ry) step(ry);
  }
}

template <int U, typename T>
int launch(const GridPlanes& planes, int C, int h, int W, float sharpen, cudaStream_t st) {
  using G = GridShape<U>;
  bool vec = W % Window<T>::kVec == 0, store32 = W % kLane == 0;
  for (int i = 0; i < U * U; ++i) {
    vec = vec && reinterpret_cast<uintptr_t>(planes.in[i]) % 16 == 0;
    store32 = store32 && reinterpret_cast<uintptr_t>(planes.out[i]) % 4 == 0;
  }
  const dim3 grid((W + kStrip - 1) / kStrip, (h + G::kRows - 1) / G::kRows, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  void (*kern)(const GridPlanes, int, int, int, int, float) = cas_grid_kernel<U, T>;
  constexpr size_t smem = window_bytes<U, T>();
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kern<<<grid, G::kThreads, smem, st>>>(planes, h, W, (int)vec, (int)store32, sharpen);
  return (int)cudaGetLastError();
}

template <int U>
int launch_u(const GridPlanes& planes, int C, int h, int W, int is_i16, float sharpen,
             cudaStream_t st) {
  return is_i16 ? launch<U, int16_t>(planes, C, h, W, sharpen, st)
                : launch<U, float>(planes, C, h, W, sharpen, st);
}

}  // namespace

// C entry point (loaded with ctypes).  in: u*u pointers to contiguous
// (C, h, W) planes of one dtype (is_i16: int16 Q2.14, else float32),
// row-major (ry, rx); out: u*u pointers to contiguous (C, h, W) uint8
// outputs.  Launches on `stream`, does not synchronise, returns the
// cudaError_t of the set-up call and the launch.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (u) {
    case 1: return launch_u<1>(planes, C, h, W, is_i16, sharpen, st);
    case 2: return launch_u<2>(planes, C, h, W, is_i16, sharpen, st);
    case 3: return launch_u<3>(planes, C, h, W, is_i16, sharpen, st);
    case 4: return launch_u<4>(planes, C, h, W, is_i16, sharpen, st);
    case 5: return launch_u<5>(planes, C, h, W, is_i16, sharpen, st);
    case 6: return launch_u<6>(planes, C, h, W, is_i16, sharpen, st);
    case 7: return launch_u<7>(planes, C, h, W, is_i16, sharpen, st);
    default: return launch_u<8>(planes, C, h, W, is_i16, sharpen, st);
  }
}

// K1 (loaded with ctypes).  p*: the four contiguous (C, h, Wh) planes
// P[ry][rx] of one dtype (is_i16: int16 Q2.14, else float32); o*: four
// contiguous (C, h, Wh) uint8 outputs, in the same order.  The U = 2
// instance of K4, with the eight pointers in row-major (ry, rx) order in
// its plane struct.  Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch.
extern "C" int vkr_cas_quad_u2(const void* p00, const void* p01,
                               const void* p10, const void* p11,
                               void* o00, void* o01, void* o10, void* o11,
                               int C, int h, int Wh, int is_i16,
                               float sharpen, void* stream) {
  if (C <= 0 || h <= 0 || Wh <= 0) return (int)cudaErrorInvalidValue;
  if (2LL * h > 0x7fffffffLL || 2LL * Wh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const GridPlanes planes = {
      {p00, p01, p10, p11},
      {static_cast<uint8_t*>(o00), static_cast<uint8_t*>(o01), static_cast<uint8_t*>(o10),
       static_cast<uint8_t*>(o11)}};
  return launch_u<2>(planes, C, h, Wh, is_i16, sharpen, static_cast<cudaStream_t>(stream));
}
