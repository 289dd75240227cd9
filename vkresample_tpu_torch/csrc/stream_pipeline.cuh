// The persistent, warp-specialized streaming pipeline shared by cas_mono.cu
// (K7, the woven CAS) and copy_quantize.cu (K10b, the same data movement
// with a plain quantize) (Hopper, sm_90a).
//
// Replaces band_pipeline.cuh, the first design of both kernels: blocks of 8
// warps walked work items (channel, band of R = min(bh, H, 192) rows, strip
// of 128 columns) through two shared-memory windows of (R+2) x 136 float32
// filled by cp.async, with two __syncthreads per item between the copy of
// the next window and the arithmetic of this one.  At bh 128 the windows
// took 141 KB, one block of 8 warps per SM; at bh 64 72 KB, three.  On the
// H100 at (3, 2048, 4096) float32 K7 took 0.0998 ms at bh 64 and 0.1348 at
// bh 128 against a bound of 37.6 us (100.7 MB read, 25.2 MB written, 3.35
// TB/s), and K10b 0.0545: the time was about the sum of data movement and
// arithmetic, not the larger of the two, because every warp of a block
// waited at a block-wide barrier for the slowest copy and the slowest row.
//
// Work.  A unit is (channel, strip of 128 columns, segment of S = min(bh,
// H) rows), numbered channel-major, then strip, then segment, so that
// consecutive units walk down one strip.  The grid is every resident block
// (two per SM, fewer for a small image); a block has one consumer warp per
// ring, at most kConsumers and no more than the units keep busy, and one
// producer warp.  The units are cut into as many contiguous runs as the
// grid has rings, balanced to one unit (run_of), and each ring streams its
// run: a stream is the run's units of one strip, their rows walked top to
// bottom, each input row leaving device memory once plus the stream's two
// halo rows (clamped at the image's edges).  So a halo row is read twice
// only where a run or a strip starts, and bh sets only how finely the runs
// balance.  The runs are fixed by the grid and the geometry, so the output
// does not depend on scheduling, and no bh >= 1 changes it.
//
// Rings.  A ring is kStages stages of kRows rows x kPitch float32 (3 pad,
// the west halo column, the strip, the east halo column, 3 pad), each with
// a full and an empty mbarrier.  The producer warp holds one lane per ring
// (its stream, chunk, stage and phase) and each pass tests every ring's
// next empty barrier.  Where W % 4 == 0 and v and out are aligned (16 and 4
// bytes), the lanes of the rings with a free stage each copy their next
// chunk at once: one arrive.expect_tx of its bytes on the full barrier,
// then one bulk copy per row (cp.async.bulk, completing on the barrier's
// transaction count), the row's columns x0-4 .. x0+131 cut at the image's
// edges.  Otherwise the whole warp copies one ring's chunk after another,
// every element a 4-byte cp.async from a clamped address (so the
// clamp-to-edge values land in the stage), and each lane's
// cp.async.mbarrier.arrive.noinc completes the full barrier.  A consumer
// warp waits on a stage's full barrier, takes its rows into registers, and
// one lane arrives on its empty barrier after a __syncwarp, so a stage is
// free again as soon as its rows are read.  Stage indices and phases run
// on across streams and runs; the only block-wide barrier is the one after
// the mbarriers are set up.  A wait that does not end within kSpinCycles (a
// fault in the phase accounting) traps, so the launch fails instead of
// hanging the card.
//
// Sizes, chosen on the H100 at (3, 2048, 4096) f32, device alone
// (scripts/torch_stream_tune.py): 3 rows a stage, 4 stages a ring, 12
// consumer warps a block, two blocks an SM (70 registers a thread); two
// stages of 6 rows, 8, 10, 14 or 16 consumers, or one block an SM read
// slower.  K7 is
// bound by instructions (about 60 a pixel for the CAS arithmetic), K10b by
// device memory at the rate K10c reaches.  At bh 128 the 1536 units keep
// six consumer warps a block busy, and each warp's latency sets K7's time.
//
// A Body turns rows into outputs, walking down a stream with the rows above
// and below in registers:
//   struct Row;                                            // one row's values
//   static __device__ void load(Row& d, const float* p, int x, int W);
//   __device__ void row(const Row& n, const Row& c, const Row& s,
//                       uint8_t (&o)[4]) const;
// where p points at the lane's first column x of a stage row (16-byte
// aligned), p[-1] and p[4] are its west and east neighbours, and row()
// gives the four uint8 outputs of the centre row c.  At the image's left
// and right edges load() repeats columns 0 and W-1 itself (a bulk copy
// leaves those stage columns unwritten); at the top and bottom the
// pipeline repeats rows 0 and H-1.
#pragma once

#include <atomic>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace ring {

constexpr int kStrip = 128;                      // columns of a strip, four per lane
constexpr int kLeft = 4;                         // stage column of the strip's first column
constexpr int kPitch = kStrip + 8;               // floats per stage row
constexpr int kRows = 3;                         // rows per stage
constexpr int kStages = 4;                       // stages per ring
constexpr int kConsumers = 12;                   // consumer warps (rings) per block
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kMinBlocks = 2;                    // resident blocks per SM the registers allow
constexpr int kStageFloats = kRows * kPitch;
constexpr int kBarriers = kConsumers * kStages;  // full barriers, then as many empty
constexpr size_t kBarrierBytes = 2 * kBarriers * sizeof(uint64_t);
constexpr size_t kSmemBytes =
    kBarrierBytes + (size_t)kBarriers * kStageFloats * sizeof(float);
constexpr long long kSpinCycles = 1LL << 35;     // ~20 s at the H100's clocks

struct Geometry {
  int H, W;
  int seg;        // rows per segment, S
  int nseg;       // segments per strip
  int nstrips;    // strips per channel
  int units;      // C * nstrips * nseg
  int consumers;  // consumer warps (rings) per block, at most kConsumers
  int rings;      // gridDim.x * consumers
};

// The units [u0, u1) of ring w of this block.  Rings are numbered slot by
// slot across the grid (r = w * gridDim.x + blockIdx.x) and the first
// units % rings of them take one unit more, so every block holds as many
// busy rings as any other, give or take one, and they are its first warps.
__device__ __forceinline__ void run_of(const Geometry& g, int w, int& u0, int& u1) {
  const int r = w * gridDim.x + blockIdx.x;
  const int q = g.units / g.rings, rem = g.units - q * g.rings;
  u0 = r * q + min(r, rem);
  u1 = u0 + q + (r < rem);
}

// The stream starting at unit u of a run ending at u1.
struct Stream {
  int c, x0;   // channel, the strip's first column
  int ys, ye;  // output rows ys .. ye-1
  int r0, n;   // rows fetched, r0 .. r0+n-1: ys-1 .. ye clamped to the image
  int next;    // the unit after the stream
};

__device__ __forceinline__ Stream stream_at(const Geometry& g, int u, int u1) {
  const int cs = u / g.nseg;  // channel * nstrips + strip
  Stream s;
  s.next = min(u1, (cs + 1) * g.nseg);
  s.c = cs / g.nstrips;
  s.x0 = (cs - s.c * g.nstrips) * kStrip;
  s.ys = (u - cs * g.nseg) * g.seg;
  s.ye = min((s.next - cs * g.nseg) * g.seg, g.H);
  s.r0 = max(s.ys - 1, 0);
  s.n = min(s.ye, g.H - 1) - s.r0 + 1;
  return s;
}

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int i) { return bars + 8 * i; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int i) {
  return bars + 8 * (kBarriers + i);
}

__device__ __forceinline__ void bar_init(uint32_t b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_test(uint32_t b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(b), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_wait(uint32_t b, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Arrive on b once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void copies_arrive(uint32_t b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(b) : "memory");
}

// The producer warp: lane r < g.consumers walks ring r's chunks.  Each
// pass every lane tests its ring's next empty barrier, each ring with a
// free stage takes its next chunk, and passes follow each other at once
// while any ring takes one.  (Filling every free stage of a ring in one
// pass made K7 0.0760 ms against 0.0668 at (3, 2048, 4096) bh 64 on the
// H100.)  kBulk: the lanes of the ready rings issue together, each an
// arrive.expect_tx of its chunk's bytes on the full barrier, then one bulk
// copy per row, the row's columns x0-4 .. x0+131 cut at the image's edges.
// Otherwise the whole warp copies one ready ring's chunk after another,
// every element a 4-byte cp.async from a clamped column, and each lane's
// cp.async.mbarrier.arrive.noinc lands on the full barrier.
template <bool kBulk>
__device__ __forceinline__ void produce(const float* __restrict__ v, const Geometry& g,
                                        uint32_t bars, uint32_t stages) {
  const int lane = threadIdx.x & 31;
  int u = 0, u1 = 0;
  if (lane < g.consumers) run_of(g, lane, u, u1);
  Stream st = stream_at(g, u, u1);
  int k = 0, stage = 0;  // the stream's next chunk; the ring's next stage
  uint32_t phase = 0;
  long long idle = clock64();
  while (__any_sync(~0u, u < u1)) {
    const bool ready = u < u1 && bar_test(empty_bar(bars, lane * kStages + stage), phase ^ 1);
    unsigned todo = __ballot_sync(~0u, ready);
    if (todo == 0) {
      if (clock64() - idle > kSpinCycles) __trap();
      continue;
    }
    idle = clock64();
    if (kBulk) {
      if (ready) {
        const int i = lane * kStages + stage;
        const int rows = min(kRows, st.n - k * kRows);
        const int xs = max(st.x0 - kLeft, 0), xe = min(st.x0 - kLeft + kPitch, g.W);
        const uint32_t bytes = (xe - xs) * sizeof(float), full = full_bar(bars, i);
        uint32_t dst = stages + (i * kStageFloats + xs - (st.x0 - kLeft)) * sizeof(float);
        const float* src = v + ((size_t)st.c * g.H + st.r0 + k * kRows) * g.W + xs;
        bar_expect(full, rows * bytes);
        for (int r = 0; r < rows; ++r, dst += kPitch * sizeof(float), src += g.W) {
          bulk_copy(dst, src, bytes, full);
        }
      }
    } else {
      __syncwarp();
      while (todo) {
        const int r = __ffs(todo) - 1;
        todo &= todo - 1;
        const int c = __shfl_sync(~0u, st.c, r), x0 = __shfl_sync(~0u, st.x0, r);
        const int row0 = __shfl_sync(~0u, st.r0 + k * kRows, r);
        const int rows = __shfl_sync(~0u, min(kRows, st.n - k * kRows), r);
        const int i = r * kStages + __shfl_sync(~0u, stage, r);
        const uint32_t dst = stages + i * kStageFloats * sizeof(float);
        const float* src = v + ((size_t)c * g.H + row0) * g.W;
        // columns x0-1 .. x0+128, clamped, at stage columns kLeft-1 ..
        constexpr int kCols = kStrip + 2;
        for (int e = lane; e < rows * kCols; e += 32) {
          const int rr = e / kCols, q = e - rr * kCols;
          copy4(dst + (rr * kPitch + kLeft - 1 + q) * sizeof(float),
                src + (size_t)rr * g.W + min(max(x0 - 1 + q, 0), g.W - 1));
        }
        copies_arrive(full_bar(bars, i));
      }
    }
    if (ready) {
      if (++k * kRows >= st.n) {
        u = st.next;
        k = 0;
        st = stream_at(g, u, u1);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// One output row of a lane: row y's four outputs from the rows above (n),
// at (c) and below (s) it, stored at o where they fall inside the image.
template <bool kWide, class Body>
__device__ __forceinline__ void emit(const Body& body, const typename Body::Row& n,
                                     const typename Body::Row& c, const typename Body::Row& s,
                                     uint8_t* o, int x, int W) {
  uint8_t q[4];
  body.row(n, c, s, q);
  if (x < W) {
    if (kWide) {
      *reinterpret_cast<uint32_t*>(o) =
          q[0] | (q[1] << 8) | (q[2] << 16) | ((uint32_t)q[3] << 24);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (x + e < W) o[e] = q[e];
      }
    }
  }
}

// A consumer warp: walks down its ring's streams, four columns a lane, a
// chunk (one stage) at a time.  A stream's first rows fill the window (row
// -1 is row 0 at the top); then every row pulled completes the window of
// the row above it, and after a stream that ends at row H-1 that row is
// computed with itself below.  A whole chunk that starts with the window
// full runs unrolled in groups of three rows, the window's registers
// rotating with the unroll, so it costs no bookkeeping per row.
template <bool kWide, class Body>
__device__ __forceinline__ void consume(uint8_t* __restrict__ out, const Geometry& g,
                                        uint32_t bars, const float* stages, int w,
                                        const Body& body) {
  static_assert(kRows % 3 == 0, "the unrolled chunk rotates the window every three rows");
  using Row = typename Body::Row;
  const int lane = threadIdx.x & 31;
  int u, u1;
  run_of(g, w, u, u1);
  const float* ring = stages + w * kStages * kStageFloats + kLeft + 4 * lane;
  int stage = 0;
  uint32_t phase = 0;
  while (u < u1) {
    const Stream st = stream_at(g, u, u1);
    const int x = st.x0 + 4 * lane, W = g.W;
    const int lag = st.ys == 0 ? 1 : 2;  // rows pulled before the first output
    uint8_t* o = out + ((size_t)st.c * g.H + st.ys) * W + x;
    Row n, c, s;
    for (int f = 0; f < st.n;) {  // f: rows of the stream pulled so far
      const int rows = min(kRows, st.n - f);
      const float* p = ring + stage * kStageFloats;
      bar_wait(full_bar(bars, w * kStages + stage), phase);
      if (rows == kRows && f >= lag) {
#pragma unroll
        for (int r = 0; r < kRows; r += 3) {
          Row a, b;
          Body::load(s, p + r * kPitch, x, W);
          Body::load(a, p + (r + 1) * kPitch, x, W);
          Body::load(b, p + (r + 2) * kPitch, x, W);
          emit<kWide>(body, n, c, s, o, x, W);
          emit<kWide>(body, c, s, a, o + W, x, W);
          emit<kWide>(body, s, a, b, o + 2 * W, x, W);
          n = a;
          c = b;
          o += 3 * W;
        }
        f += kRows;
      } else {
        for (int r = 0; r < rows; ++r, ++f) {
          Body::load(s, p + r * kPitch, x, W);
          if (f == 0) {
            n = s;
            c = s;
          } else if (f == 1 && lag == 2) {
            c = s;
          } else {
            emit<kWide>(body, n, c, s, o, x, W);
            o += W;
            n = c;
            c = s;
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty_bar(bars, w * kStages + stage));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (st.ye == g.H) emit<kWide>(body, n, c, c, o, x, W);  // row H is row H-1
    u = st.next;
  }
}

// kVec: bulk copies in, 32-bit stores out (W % 4 == 0, v 16-byte and out
// 4-byte aligned); else 4-byte cp.async in, byte stores out.
template <bool kVec, class Body>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stream_kernel(const float* __restrict__ v, uint8_t* __restrict__ out, Geometry g, Body body) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = threadIdx.x >> 5;  // warp g.consumers is the producer
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBarriers; ++i) {
      bar_init(full_bar(bars, i), kVec ? 1 : 32);
      bar_init(empty_bar(bars, i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set up; no block-wide barrier follows
  if (warp == g.consumers) {
    produce<kVec>(v, g, bars, bars + (uint32_t)kBarrierBytes);
  } else {
    consume<kVec>(out, g, bars, reinterpret_cast<const float*>(smem + kBarrierBytes), warp,
                  body);
  }
}

// Launch stream_kernel for v: contiguous (C, H, W) float32, out: contiguous
// (C, H, W) uint8, in segments of bh rows, on `stream`; does not
// synchronise; returns the first cudaError_t of the set-up calls and the
// launch.  Each instance's shared-memory size and grid are set up once per
// device.
template <class Body>
int launch(const void* v, void* out, int C, int H, int W, int bh, Body body, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0 || bh <= 0) return (int)cudaErrorInvalidValue;
  Geometry g;
  g.H = H;
  g.W = W;
  g.seg = bh < H ? bh : H;
  g.nseg = 1 + (H - 1) / g.seg;
  g.nstrips = 1 + (W - 1) / kStrip;
  const long long units = (long long)C * g.nstrips * g.nseg;
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  g.units = (int)units;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  void (*kern)(const float*, uint8_t*, Geometry, Body) =
      vec ? stream_kernel<true, Body> : stream_kernel<false, Body>;
  // per device and instance: resident blocks over the card, once set up
  constexpr int kMaxDevices = 64;
  static std::atomic<int> slots[2][kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int blocks = slots[vec][dev].load();
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBytes);
    }
    if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmemBytes);
    }
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    slots[vec][dev].store(blocks);
  }
  // every resident block, but none without a unit, and in each no more
  // consumer warps than the units keep busy
  const int grid = units < blocks ? (int)units : blocks;
  const long long per_block = (units + grid - 1) / grid;
  g.consumers = per_block < kConsumers ? (int)per_block : kConsumers;
  g.rings = grid * g.consumers;
  kern<<<grid, 32 * (g.consumers + 1), kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<uint8_t*>(out), g, body);
  return (int)cudaGetLastError();
}

}  // namespace ring
}  // namespace
