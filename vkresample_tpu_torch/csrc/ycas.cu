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
// Bound on this card.  The GEMM in the form it runs here, three TF32
// products per multiply-add (below): 3 * 2*C*h*(h+r)*W operations, ~60.5
// G at 1440x1080 -> 2880x2160 (h = 1080, W = 2880), ~0.122 ms at the 495
// TFLOP/s TF32 tensor-core peak, against ~42 MB (int16) moved, ~13 us at
// 3.35 TB/s: operations bound it.  (The same GEMM in fp32 FMA outside the
// tensor cores, 20.2 GFLOP at 67 TFLOP/s, takes at least ~0.30 ms.)
//
// Design.
// - Tensor cores at fp32 accuracy ("3xTF32", as the JAX kernel split its
//   bank into bf16 hi|lo for the TPU's matrix unit): every operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi), each rounded to TF32 as
//   cvt.rna.tf32.f32 rounds (nearest, ties away: add half a TF32 ulp to
//   the bits, clear the 13 low bits; x - hi is exact in float32), and O
//   sums lo.hi + hi.lo + hi.hi with float32 accumulation.  An int16 U
//   dequantizes exactly (v * 2^-14) first, and its split is exact (15
//   significant bits).  The tensor cores add with truncation, so each
//   32-deep chunk sums into a fresh accumulator that is then added to the
//   running O in round-to-nearest float32: the truncations act on partial
//   sums of 12 products, not on the whole of O.
// - The GEMM runs transposed, O^T = U^T . YT^T, on wgmma m64n128k8 TF32:
//   the operand in registers (A, 64 rows) is U^T, split there, and the one
//   in shared memory (B) is YT, split into hi and lo chunks, K-major with
//   the 128-byte swizzle (a chunk row of 32 values is one swizzled line):
//   TF32 takes only K-major operands from shared memory, and YT's rows are
//   K-major as they lie.  One block per (channel, strip of kBW = 126 output
//   columns, band of kBO = 127 plane rows [a, a+127)) computes the 128 x
//   128 tile of O rows [a-1, a+127) (the north halo row recomputed) by
//   columns [x0-1, x0+127) (both halo columns recomputed): 98 % of the tile
//   are outputs.  Row indices of YT clamp to the plane; the CAS clamps its
//   column neighbours (column 0 west of itself, W-1 east of itself).
// - Three warpgroups with their own roles.  Warpgroups 0 and 1, the
//   consumers, take tile columns 64q .. 64q+63 by all 128 rows (64 float32
//   accumulators a thread, and 64 for the chunk's); one that lies wholly
//   past column W-1 (the last strip) skips its products.  Warpgroup 2, the
//   producer, makes the copies and splits YT, so the consumers' wgmma
//   issue never waits on them: chunk c+1's copies land in stage (c+1) % 3
//   (a raw YT chunk, 128 x 32 at a pitch of 36 floats, and the U or T2
//   rows, 32 x the strip's window at a pitch of 136 floats or 144 int16, so
//   fragment loads hit 32 distinct banks) while the producer splits chunk c
//   into hi/lo pair c % 2; named barriers pass each chunk from producer to
//   consumers (full) and back (done), and the consumers' two warpgroups run
//   out of step, one's products filling the tensor cores while the other
//   loads fragments.  setmaxnreg gives the consumers 176 registers and the
//   producer 152 (no spills either side).  The contraction runs over the U
//   rows (K = h, U as stored), then the T2 rows (K = r, float32).
// - What bounds this on the card, past the tensor cores, is the bytes moved
//   from L2 into shared memory: each block reads its band's YT rows and its
//   strip's U columns over all of K.  So YT is read raw (4 bytes a value,
//   not a split 8) and split in shared memory once per block.
// - Copies are 16-byte cp.async.  YT comes padded once per bank by the
//   wrapper (ops/ycas_cuda.py::ycas_bank_padded: its U columns at 0 and its
//   T2 columns at the next multiple of 4, zero between, rows of a multiple
//   of 4), so every chunk of it is.  U and T2 are where rows allow it (W % 4
//   == 0 for float32, W % 8 == 0 for int16, 16-byte aligned bases): the
//   window then starts at the 16-byte boundary at or before column x0-1,
//   and each chunk of a row lies wholly inside or outside the plane; else
//   every element is copied on its own (a 4-byte cp.async, or an int16
//   through a register), as cas_rows.cu stages.  Which form runs is the
//   same for every block.  Copies outside the plane or past K are
//   zero-filled (cp.async's src-size), so no chunk reads past its array.
//   The split chunks are made visible to the tensor cores' (async proxy)
//   reads with fence.proxy.async before the full barrier.
// - The CAS in the epilogue, from shared memory: after the GEMM the
//   producer copies U rows a .. a+127 of the strip into the free stages and
//   the consumers write the accumulators beside them as L = clip_len(O);
//   then all 384 threads, three to a column, evaluate both output parities
//   per position with the per-parity stencil of _parity_planes: even row
//   2t has N = O[t-1] (itself at t = 0), C = U[t], S = O[t]; odd row 2t+1
//   has N = U[t], C = O[t], S = U[t+1] (itself at t = h-1).  Any h, W >= 1
//   and r >= 0 runs: the TPU kernels' strip/halo DMA geometry (Wb, bo,
//   HALO, RPAD) and their support gate have no counterpart here.
// - Dynamic shared memory: 169 KB (three stages, two hi/lo pairs), above
//   the 48 KB static limit, so the launch raises the kernel's limit once
//   per device (a refused launch returns its error).
// K8 and K9 are one template: they sum in the same order, so K9 is the
// woven K8 on every pixel.
#include "cas_common.cuh"

#include <atomic>

namespace {

constexpr int kM = 128;          // O rows per tile: kBO band rows + 1 halo
constexpr int kN = 128;          // columns per tile: kBW + 2 halo
constexpr int kBO = kM - 1;      // plane rows per band
constexpr int kBW = kN - 2;      // output columns per strip
constexpr int kBK = 32;          // contraction rows per chunk
constexpr int kStages = 3;       // copy stages
constexpr int kConsumers = 256;  // warpgroups 0 and 1: the products, 64 tile columns each
constexpr int kProducers = 128;  // warpgroup 2: copies and the split of YT
constexpr int kThreads = kConsumers + kProducers;
// named barriers (0 is __syncthreads): chunk c's stage and hi/lo pair full
// (kFull + c % 2) and done with (kEmpty + c % 2), the producers' own, the
// consumers' own, and the CAS's U rows landed
constexpr int kFull = 1, kEmpty = 3, kProdBar = 5, kConsBar = 6, kUtBar = 7;
constexpr int kOP = kN + 8;      // O tile and float32 B row pitch: 136 = 8 mod 32
constexpr int kYP = kBK + 4;     // raw YT chunk row pitch (floats): 8 rows, 8 bank groups
// YT's TF32 hi and lo chunks, K-major with the 128-byte swizzle: a row's
// kBK = 32 values fill one 128-byte line, and its 16-byte group j lies at
// byte (m * 128) + ((j ^ (m % 8)) * 16), so 8 rows (1024 bytes, kSBO) make
// one swizzle atom
constexpr int kSBO = 1024;
static_assert(kBK * 4 == 128, "a chunk row is one 128-byte swizzle line");

// A staged row of T: elements per 16-byte copy and row pitch (elements).
template <typename T>
struct Rows;
template <>
struct Rows<float> {
  static constexpr int kVec = 4, kPitch = kOP;
};
template <>
struct Rows<int16_t> {
  static constexpr int kVec = 8, kPitch = 144;  // 72 words = 8 mod 32
};
// 16-byte chunks per staged row: columns x0-1 .. x0+kN-2 from a 16-byte
// boundary up to kVec-1 columns before them
template <typename T>
constexpr int kChunks = (kN + 2 * Rows<T>::kVec - 2) / Rows<T>::kVec;
static_assert(kChunks<float> * 4 <= Rows<float>::kPitch, "float window");
static_assert(kChunks<int16_t> * 8 <= Rows<int16_t>::kPitch, "int16 window");

// Shared memory: kStages copy stages, each a raw YT chunk and the B rows
// of the chunk, then two pairs of TF32 hi and lo chunks.  After the GEMM the
// O tile and, after it, the CAS's U rows take their place.
constexpr int kRawBytes = kM * kYP * 4;
constexpr int kBBytes = kBK * kOP * 4;  // the float32 layout; int16's is smaller
constexpr int kStageBytes = kRawBytes + kBBytes;
constexpr int kSplitBytes = kM * kBK * 4;  // one hi or lo chunk
constexpr int kSplitAt = kStages * kStageBytes;
constexpr int kSmemBytes = kSplitAt + 4 * kSplitBytes;
constexpr int kUtAt = kM * kOP * 4;  // after the O tile
static_assert(kSBO * (kM / 8) == kSplitBytes, "swizzle atoms");
static_assert(kSplitAt % 1024 == 0 && kSplitBytes % 1024 == 0, "atoms 1024-byte aligned");
static_assert(kBK * Rows<int16_t>::kPitch * 2 <= kBBytes, "int16 B rows fit a stage");
static_assert(kUtAt + kM * Rows<float>::kPitch * 4 <= kSmemBytes, "O tile and U rows fit");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cp.async with zero fill: `bytes` (0 .. size) come from src, the rest is 0.
__device__ __forceinline__ void cp16z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp4z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One element, or 0 where !ok: a 4-byte cp.async for float32; cp.async
// has no 2-byte form, so an int16 goes through a register.
__device__ __forceinline__ void copy_elem_z(float* dst, const float* src, bool ok) {
  cp4z(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_elem_z(int16_t* dst, const int16_t* src, bool ok) {
  *dst = ok ? __ldg(src) : (int16_t)0;
}

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(int16_t v) {
  return __fmul_rn((float)v, 1.0f / 16384.0f);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away from
// zero, the 13 low mantissa bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// The descriptor of a K-major TF32 operand in shared memory at p, in the
// 128-byte swizzle layout above (p: the atom's start, plus the byte offset
// of the 8-deep step along K); the leading byte offset is unused there.
__device__ __forceinline__ uint64_t yt_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(kSBO >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps the compiler from moving a register's reads or writes across the
// point where it stands (wgmma reads and writes its registers
// asynchronously).
__device__ __forceinline__ void hold(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// D (64 x 128, float32, 64 registers a thread) += A . B on the warpgroup's
// tensor cores: wgmma m64n128k8 TF32, A (64 x 8) from registers, B (8 x
// 128) K-major from shared memory through its descriptor; scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The first staged column of a strip in 16-byte form: the 16-byte boundary
// at or before column x0-1 (x0 = 0: -kVec, a chunk that is all zero fill).
template <typename T>
__device__ __forceinline__ int window_start(int x0) {
  constexpr int V = Rows<T>::kVec;
  return x0 == 0 ? -V : (x0 - 1) / V * V;
}
// Where tile column 0 (image column x0-1) sits in a staged row.
template <typename T>
__device__ __forceinline__ int window_offset(int x0, bool vec) {
  return vec ? x0 - 1 - window_start<T>(x0) : 0;
}

// Start the copies of rows first .. first+kRows-1 of the plane P (rows <
// end exist) by the strip's columns into dst, rows of Rows<T>::kPitch:
// 16-byte chunks from window_start (vec), else columns x0-1 .. x0+kN-2 one
// by one.  Rows and columns outside the plane are zero.  kBy threads copy,
// this one tid of them.
template <typename T, int kRows, int kBy>
__device__ __forceinline__ void stage_rows(T* dst, const T* P, int first, int end, int x0,
                                           int W, bool vec, int tid) {
  constexpr int V = Rows<T>::kVec, kP = Rows<T>::kPitch, kC = kChunks<T>;
  // each loop a fixed count of steps, unrolled, so a thread's copies go
  // out together
  if (vec) {
    const int xs = window_start<T>(x0);
#pragma unroll
    for (int step = 0; step < (kRows * kC + kBy - 1) / kBy; ++step) {
      const int idx = tid + step * kBy;
      if ((kRows * kC) % kBy != 0 && idx >= kRows * kC) break;
      const int i = idx / kC, j = idx - i * kC;
      const int y = first + i, x = xs + j * V;
      const bool ok = y < end && x >= 0 && x < W;
      cp16z(dst + i * kP + j * V, ok ? P + (size_t)y * W + x : P, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < kRows * kN; idx += kBy) {
      const int i = idx / kN, n = idx - i * kN;
      const int y = first + i, x = x0 - 1 + n;
      const bool ok = y < end && x >= 0 && x < W;
      copy_elem_z(dst + i * kP + n, ok ? P + (size_t)y * W + x : P, ok);
    }
  }
}

// Start the copies of a raw YT chunk: tile row m from YTp row clamp(a-1+m),
// columns kbase + k0 .. kbase + k0 + kBK-1 (rows of kYP floats), zero from
// column kbase + n on (YTp's pad columns are zero, so a 4-column group
// that starts below n is copied whole).
__device__ __forceinline__ void stage_yt(float* raw, const float* YTp, int a, int h, int Kp,
                                         int kbase, int n, int k0, int tid) {
  constexpr int kG = kBK / 4;
  static_assert(kM * kG % kProducers == 0, "whole steps");
#pragma unroll
  for (int step = 0; step < kM * kG / kProducers; ++step) {
    const int idx = tid + step * kProducers;
    const int m = idx / kG, j = idx - m * kG;
    const int k = k0 + 4 * j;
    const float* row = YTp + (size_t)min(max(a - 1 + m, 0), h - 1) * Kp + kbase;
    cp16z(raw + m * kYP + 4 * j, k < n ? row + k : row, k < n ? 16 : 0);
  }
}

// Split a landed raw YT chunk into its TF32 hi and lo chunks in the
// swizzled layout.  Eight neighbouring threads take 8 rows of one 4-column
// group: 16-byte loads from rows kYP floats apart and 16-byte stores to 8
// swizzled positions, each without bank conflicts.
__device__ __forceinline__ void split_yt(const float* raw, unsigned char* hi_s,
                                         unsigned char* lo_s, int tid) {
#pragma unroll
  for (int step = 0; step < kM * (kBK / 4) / kProducers; ++step) {
    const int idx = tid + step * kProducers;
    const int r8 = idx & 7, j = (idx >> 3) & 7, m = r8 + 8 * (idx >> 6);
    const float4 v = *reinterpret_cast<const float4*>(raw + m * kYP + 4 * j);
    uint4 hi, lo;
    split(v.x, hi.x, lo.x);
    split(v.y, hi.y, lo.y);
    split(v.z, hi.z, lo.z);
    split(v.w, hi.w, lo.w);
    const int off = m * 128 + ((j ^ r8) * 16);
    *reinterpret_cast<uint4*>(hi_s + off) = hi;
    *reinterpret_cast<uint4*>(lo_s + off) = lo;
  }
}

// Load and split the warpgroup's U^T fragments of a staged B chunk: A rows
// (tile columns) c0 + g and c0 + g + 8, contraction rows t and t + 4 of
// each 8-deep step.
template <typename TB>
__device__ __forceinline__ void load_a(uint32_t (&ah)[kBK / 8][4], uint32_t (&al)[kBK / 8][4],
                                       const TB* Bs, int off) {
  constexpr int kP = Rows<TB>::kPitch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const TB* col = Bs + off + (warp >> 2) * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int q = 0; q < kBK / 8; ++q) {
    const int kk = 8 * q;
    split(load_f(col[(kk + t) * kP]), ah[q][0], al[q][0]);
    split(load_f(col[(kk + t) * kP + 8]), ah[q][1], al[q][1]);
    split(load_f(col[(kk + t + 4) * kP]), ah[q][2], al[q][2]);
    split(load_f(col[(kk + t + 4) * kP + 8]), ah[q][3], al[q][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hold(ah[q][e]);
      hold(al[q][e]);
    }
  }
}

// Issue a chunk's products on the tensor cores into part, a fresh
// accumulator (kFull: all kBK contraction rows valid, else rows 0 ..
// valid-1): lo.hi, hi.lo, hi.hi of each 8-deep step.
template <bool kFull>
__device__ __forceinline__ void issue_mma(float (&part)[64], uint32_t (&ah)[kBK / 8][4],
                                          uint32_t (&al)[kBK / 8][4],
                                          const unsigned char* hi_s,
                                          const unsigned char* lo_s, int valid) {
#pragma unroll
  for (int i = 0; i < 64; ++i) hold(part[i]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < kBK / 8; ++q) {
    if (!kFull && 8 * q >= valid) break;
    const uint64_t dh = yt_desc(hi_s + q * 32), dl = yt_desc(lo_s + q * 32);
    wgmma_tf32(part, al[q], dh, q > 0);
    wgmma_tf32(part, ah[q], dl, 1);
    wgmma_tf32(part, ah[q], dh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for the products issued, then acc += part in round-to-nearest.
__device__ __forceinline__ void finish_mma(float (&acc)[64], float (&part)[64],
                                           uint32_t (&ah)[kBK / 8][4],
                                           uint32_t (&al)[kBK / 8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < kBK / 8; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hold(ah[q][e]);
      hold(al[q][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    hold(part[i]);
    acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// Where a chunk lives: chunk c's copies in stage c % kStages, its split YT
// in hi/lo pair c % 2.
struct Smem {
  unsigned char* base;
  __device__ float* raw(int c) const {
    return reinterpret_cast<float*>(base + (c % kStages) * kStageBytes);
  }
  template <typename TB>
  __device__ TB* b(int c) const {
    return reinterpret_cast<TB*>(base + (c % kStages) * kStageBytes + kRawBytes);
  }
  __device__ unsigned char* hi(int c) const { return base + kSplitAt + 2 * (c & 1) * kSplitBytes; }
  __device__ unsigned char* lo(int c) const {
    return base + kSplitAt + (2 * (c & 1) + 1) * kSplitBytes;
  }
};

// The producers' part of one contraction pass, YTp[tile rows, kbase ..
// kbase+n-1] against P[0 .. n-1, tile columns], in chunks: copy chunk c+1
// while chunk c lands, split chunk c's YT into its hi/lo pair, signal it
// full; a stage and a pair are reused once the consumers signal the chunk
// two back done.  Returns once the consumers are done with every chunk.
template <typename TB>
__device__ __forceinline__ void produce(const Smem& sm, const float* YTp, const TB* P, int a,
                                        int h, int Kp, int kbase, int n, int x0, int W,
                                        bool vec_b, int tid) {
  const int nch = (n + kBK - 1) / kBK;
  auto stage = [&](int c) {
    stage_yt(sm.raw(c), YTp, a, h, Kp, kbase, n, c * kBK, tid);
    stage_rows<TB, kBK, kProducers>(sm.b<TB>(c), P, c * kBK, n, x0, W, vec_b, tid);
  };
  stage(0);
  cp_commit();
  for (int c = 0; c < nch; ++c) {
    if (c >= 2) bar_sync(kEmpty + (c & 1), kThreads);  // chunk c-2 done
    if (c + 1 < nch) stage(c + 1);
    cp_commit();
    cp_wait<1>();
    bar_sync(kProdBar, kProducers);  // chunk c landed for all producers
    split_yt(sm.raw(c), sm.hi(c), sm.lo(c), tid);
    // the split chunk visible to the tensor cores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_arrive(kFull + (c & 1), kThreads);
  }
  for (int c = max(nch - 2, 0); c < nch; ++c) bar_sync(kEmpty + (c & 1), kThreads);
}

// The consumers' part of the same pass: acc += (the pass's product)^T,
// chunk by chunk as the producers fill them.
template <typename TB>
__device__ __forceinline__ void consume(float (&acc)[64], float (&part)[64], const Smem& sm,
                                        int n, int x0, bool vec_b, bool active) {
  const int nch = (n + kBK - 1) / kBK;
  const int off = window_offset<TB>(x0, vec_b);
  for (int c = 0; c < nch; ++c) {
    const int valid = min(kBK, n - c * kBK);
    bar_sync(kFull + (c & 1), kThreads);
    if (active) {  // the warpgroup's columns hold something an output reads
      uint32_t ah[kBK / 8][4], al[kBK / 8][4];
      load_a<TB>(ah, al, sm.b<TB>(c), off);
      if (valid == kBK) {
        issue_mma<true>(part, ah, al, sm.hi(c), sm.lo(c), valid);
      } else {
        issue_mma<false>(part, ah, al, sm.hi(c), sm.lo(c), valid);
      }
      finish_mma(acc, part, ah, al);
    }
    bar_arrive(kEmpty + (c & 1), kThreads);
  }
}

// The CAS of a band and strip from the L values of the O tile and the U
// rows as stored, by all kThreads threads: thread column n of the tile
// (image column x) walks down a third of the band's rows, keeping the L
// values of the rows around the current one in registers, so each row step
// reads one O row and one U row.
template <typename T, bool kWovenOut>
__device__ __forceinline__ void cas_band(const float* Ot, const T* Ut, uint8_t* out0,
                                         uint8_t* out1, size_t c, int a, int x0, int h, int W,
                                         bool vec_u, float sharpen) {
  constexpr int kUP = Rows<T>::kPitch;
  constexpr int kPart = (kBO + 2) / 3;  // rows a thread walks
  static_assert(kThreads == 3 * kN, "three threads a column");
  const int n = (threadIdx.x & (kN - 1)) + 1;
  const int x = x0 - 1 + n;
  const int s_first = (threadIdx.x / kN) * kPart, s_last = min(s_first + kPart, min(kBO, h - a));
  if (n > kBW || x >= W || s_first >= s_last) return;
  const int nw = x == 0 ? n : n - 1, ne = x == W - 1 ? n : n + 1;
  const T* ur = Ut + window_offset<T>(x0, vec_u);
  auto u_row = [&](int s, float (&v)[3]) {
    const T* u = ur + s * kUP;
    v[0] = clip_len(u[nw]);
    v[1] = clip_len(u[n]);
    v[2] = clip_len(u[ne]);
  };
  auto o_row = [&](int s, float (&v)[3]) {
    const float* o = Ot + s * kOP;
    v[0] = o[nw];
    v[1] = o[n];
    v[2] = o[ne];
  };
  // O[t-1], U[t], O[t], U[t+1] at t = a + s: tile rows s, s, s+1, s+1
  float o0[3], u0[3], o1[3], u1[3];
  o_row(s_first, o0);
  u_row(s_first, u0);
  o_row(s_first + 1, o1);
  for (int s = s_first; s < s_last; ++s) {
    const int t = a + s;
    u_row(s + 1, u1);
    // even row's north: O[t-1], U[0] at t = 0; odd row's south: U[t+1],
    // O[h-1] at t = h-1
    const bool top = t == 0, bottom = t == h - 1;
    const uint8_t even = cas_pixel(top ? u0[0] : o0[0], top ? u0[1] : o0[1],
                                   top ? u0[2] : o0[2], u0[0], u0[1], u0[2], o1[0], o1[1],
                                   o1[2], sharpen);
    const uint8_t odd = cas_pixel(u0[0], u0[1], u0[2], o1[0], o1[1], o1[2],
                                  bottom ? o1[0] : u1[0], bottom ? o1[1] : u1[1],
                                  bottom ? o1[2] : u1[2], sharpen);
    if (kWovenOut) {
      uint8_t* oc = out0 + c * 2 * (size_t)h * (size_t)W;
      oc[(size_t)(2 * t) * W + x] = even;
      oc[(size_t)(2 * t + 1) * W + x] = odd;
    } else {
      const size_t o = c * (size_t)h * (size_t)W + (size_t)t * W + x;
      out0[o] = even;
      out1[o] = odd;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o0[i] = o1[i];
      u0[i] = u1[i];
    }
    if (s + 2 < kM) o_row(s + 2, o1);
  }
}

template <typename T, bool kWovenOut>
__global__ void __launch_bounds__(kThreads, 1)
ycas_kernel(const T* __restrict__ U, const float* __restrict__ T2,
            const float* __restrict__ YTp, uint8_t* __restrict__ out0,
            uint8_t* __restrict__ out1, int h, int W, int r, float sharpen) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Smem sm{smem};
  T* Ut = reinterpret_cast<T*>(smem + kUtAt);  // U rows a .. a+kM-1, as stored

  const size_t c = blockIdx.z;
  const int a = blockIdx.y * kBO;
  const int x0 = blockIdx.x * kBW;
  const int hp = (h + 3) & ~3, Kp = hp + ((r + 3) & ~3);
  const T* Uc = U + c * (size_t)h * (size_t)W;
  const float* Tc = r > 0 ? T2 + c * (size_t)r * (size_t)W : nullptr;
  const bool vec_u = W % Rows<T>::kVec == 0 && aligned16(U);
  const bool vec_t = W % 4 == 0 && aligned16(T2);
  const int warp = threadIdx.x >> 5;

  float* Ot = reinterpret_cast<float*>(smem);  // after the GEMM: L of the O tile
  if (threadIdx.x >= kConsumers) {
    // the producers hand registers to the consumers: 128 x 152 + 256 x 176
    // = 64512 of the SM's 65536 (a split of all 65536 never got its
    // registers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n" ::: "memory");
    const int tid = threadIdx.x - kConsumers;
    produce<T>(sm, YTp, Uc, a, h, Kp, 0, h, x0, W, vec_u, tid);
    if (r > 0) produce<float>(sm, YTp, Tc, a, h, Kp, hp, r, x0, W, vec_t, tid);
    // the stages are free: the CAS's U rows in their place
    stage_rows<T, kM, kProducers>(Ut, Uc, a, h, x0, W, vec_u, tid);
    cp_commit();
    cp_wait<0>();
    bar_sync(kUtBar, kThreads);  // the U rows landed, the O tile written
    cas_band<T, kWovenOut>(Ot, Ut, out0, out1, c, a, x0, h, W, vec_u, sharpen);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n" ::: "memory");
  // tile columns x0-1 .. W-1 are read by an output: a warpgroup whose 64
  // columns lie past them skips its products
  const bool active = (warp >> 2) * 64 < W - x0 + 1;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  consume<T>(acc, part, sm, h, x0, vec_u, active);
  if (r > 0) consume<float>(acc, part, sm, r, x0, vec_t, active);
  bar_sync(kConsBar, kConsumers);  // both warpgroups done with the stages

  // L of the O tile into the stages' memory: Ot[m][n] is O row a-1+m,
  // column x0-1+n.  A thread's acc[4j + e] holds tile column (wgmma row)
  // c0 + g (+ 8 for e >= 2) and tile row (wgmma column) 8j + 2t (+ 1 for
  // odd e).
  {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int c0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ot[(8 * j + 2 * t + (e & 1)) * kOP + c0 + 8 * (e >> 1)] = clip_len(acc[4 * j + e]);
      }
    }
  }
  bar_sync(kUtBar, kThreads);  // the O tile written, the U rows landed
  cas_band<T, kWovenOut>(Ot, Ut, out0, out1, c, a, x0, h, W, vec_u, sharpen);
}

// Raise the kernel's dynamic shared memory limit on the current device,
// once per device (devices 0..63; others every launch).
template <typename T, bool kWovenOut>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(ycas_kernel<T, kWovenOut>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <typename T, bool kWovenOut>
int launch_t(const T* U, const float* t2, const float* ytp, uint8_t* o0, uint8_t* o1,
             dim3 grid, int h, int W, int r, float sharpen, cudaStream_t st) {
  const cudaError_t e = allow_smem<T, kWovenOut>();
  if (e != cudaSuccess) return (int)e;
  ycas_kernel<T, kWovenOut><<<grid, kThreads, kSmemBytes, st>>>(U, t2, ytp, o0, o1, h,
                                                                      W, r, sharpen);
  return (int)cudaGetLastError();
}

template <bool kWovenOut>
int launch(const void* U, const void* T2, const void* YTp, void* out0, void* out1,
           int C, int h, int W, int r, int is_i16, float sharpen, void* stream) {
  if (C <= 0 || h <= 0 || W <= 0 || r < 0 || (r > 0 && T2 == nullptr) ||
      (reinterpret_cast<uintptr_t>(YTp) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBW - 1) / kBW, (h + kBO - 1) / kBO, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t2 = static_cast<const float*>(T2);
  const float* ytp = static_cast<const float*>(YTp);
  uint8_t* o0 = static_cast<uint8_t*>(out0);
  uint8_t* o1 = static_cast<uint8_t*>(out1);
  if (is_i16) {
    return launch_t<int16_t, kWovenOut>(static_cast<const int16_t*>(U), t2, ytp, o0, o1, grid,
                                        h, W, r, sharpen, st);
  }
  return launch_t<float, kWovenOut>(static_cast<const float*>(U), t2, ytp, o0, o1, grid, h, W,
                                    r, sharpen, st);
}

}  // namespace

// C entry points (loaded with ctypes).  U: contiguous (C, h, W) (is_i16:
// int16 Q2.14, else float32); T2: contiguous (C, r, W) float32, null when
// r = 0; YTp: the y bank YT (h, h + r) padded, contiguous (h, Kp)
// float32, 16-byte aligned, with Kp = hp + rp and hp, rp = h, r rounded up
// to 4: YT's first h columns at 0 .. h-1, its last r at hp .. hp+r-1, zero
// elsewhere (ops/ycas_cuda.py::ycas_bank_padded).  K8
// writes the even and odd row planes E, D, contiguous (C, h, W) uint8; K9
// the woven (C, 2h, W) uint8 image.  Launch on `stream`, do not
// synchronise, return the cudaError_t of the launch (or of raising the
// kernel's shared memory limit).
extern "C" int vkr_ycas_parity_u2(const void* U, const void* T2, const void* YTp,
                                  void* E, void* D, int C, int h, int W, int r,
                                  int is_i16, float sharpen, void* stream) {
  return launch<false>(U, T2, YTp, E, D, C, h, W, r, is_i16, sharpen, stream);
}

extern "C" int vkr_ycas_u2(const void* U, const void* T2, const void* YTp, void* out,
                           int C, int h, int W, int r, int is_i16, float sharpen,
                           void* stream) {
  return launch<true>(U, T2, YTp, out, nullptr, C, h, W, r, is_i16, sharpen, stream);
}
