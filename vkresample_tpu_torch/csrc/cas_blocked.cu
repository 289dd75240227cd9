// Woven CAS + quantize over row blocks whose one-row halos are built
// outside the kernel (Hopper, sm_90a).
//
// Replaces vkresample_tpu/ops/cas_pallas.py::cas_quantize_blocked (kernel
// body _cas_blk_kernel).
//
// What it computes.  A float32 pre-CAS image v (C, H, W), cut into nb =
// ceil(H / bh) blocks of bh rows, goes to the uint8 image (C, H, W): the
// 3x3 clamp-to-edge CAS of L = min(|v|, 1) with the sqrt/divide blend
// (cas_common.cuh::cas_pixel_sqrt), then (int)clamp(out*255, 0, 255).
// The kernel reads no row of v outside the block it writes.  The north
// neighbour of a block's first row and the south neighbour of its last
// valid row come from the separate inputs top and bot (C, nb, W), float32,
// which the caller gathers: top[c, i] = v[c, max(i*bh - 1, 0)] and
// bot[c, i] = v[c, min((i+1)*bh, H - 1)].  With those halos the output is
// the whole-image CAS and does not depend on bh; a caller that holds only
// its own rows (a sharded image, whose halo rows come from the
// neighbouring card) hands in the neighbours' rows instead.
//
// Bound on this card.  About 40 flops per output pixel against 4 bytes
// read and 1 written: device memory bounds it.  At (3, 2048, 4096) it reads
// 100.7 MB of float32 plus 2*C*nb*W*4 bytes of halo rows (3.1 MB at bh =
// 64) and writes 25.2 MB: ~38.5 us at the 3.35 TB/s peak.
//
// Design.  One block of threads covers one (channel, row block, strip of 32
// columns).  It walks its row block in chunks of 16 rows; for each it
// stages the (16+2) x (32+2) window of L values in shared memory, window
// row j (block-local, -1 .. 16) taken from top when j < 0, from bot when j
// is past the block's last valid row (H-1-i*bh for a ragged last block,
// else bh-1), and from v otherwise; columns clamp to [0, W-1].  Every
// H, W, bh >= 1 runs: the TPU kernel's 8-sublane halo padding and its
// bh < 8 / W % 128 XLA fallback have no counterpart here.
#include "cas_common.cuh"

namespace {

constexpr int kTX = 32;             // columns per block (one per thread)
constexpr int kTY = 8;              // thread rows per block
constexpr int kRows = 2;            // output rows per thread and chunk
constexpr int kTH = kTY * kRows;    // rows per chunk
constexpr int kSW = kTX + 2;        // tile width incl. halo
constexpr int kSH = kTH + 2;        // tile height incl. halo

__global__ void __launch_bounds__(kTX * kTY)
cas_blocked_kernel(const float* __restrict__ v, const float* __restrict__ top,
                   const float* __restrict__ bot, uint8_t* __restrict__ out,
                   int H, int W, int bh, int nb, float sharpen) {
  __shared__ float tile[kSH][kSW];
  const size_t c = blockIdx.z;
  const int i = blockIdx.y;
  const int x0 = blockIdx.x * kTX;
  const int y0 = i * bh;                  // the block's first image row
  const int last = min(bh, H - y0) - 1;   // its last valid block-local row
  const float* vb = v + (c * H + y0) * (size_t)W;
  const float* tr = top + (c * nb + i) * (size_t)W;
  const float* br = bot + (c * nb + i) * (size_t)W;
  uint8_t* ob = out + (c * H + y0) * (size_t)W;
  const int x = x0 + threadIdx.x;

  for (int j0 = 0; j0 <= last; j0 += kTH) {
    for (int k = threadIdx.y * kTX + threadIdx.x; k < kSH * kSW; k += kTX * kTY) {
      const int r = k / kSW, q = k - r * kSW;
      const int j = j0 - 1 + r;
      const float* row = j < 0 ? tr : j > last ? br : vb + (size_t)j * W;
      tile[r][q] = clip_len(row[min(max(x0 - 1 + q, 0), W - 1)]);
    }
    __syncthreads();
    if (x < W) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int ty = threadIdx.y + k * kTY;
        if (j0 + ty <= last) {
          ob[(size_t)(j0 + ty) * W + x] =
              cas_at<kSW, true>(tile, ty + 1, threadIdx.x + 1, sharpen);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the tile
  }
}

}  // namespace

// C entry point (loaded with ctypes).  v: contiguous (C, H, W) float32;
// top, bot: contiguous (C, ceil(H/bh), W) float32 halo rows; out:
// contiguous (C, H, W) uint8.  Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch.
extern "C" int vkr_cas_blocked(const void* v, const void* top, const void* bot, void* out,
                               int C, int H, int W, int bh, float sharpen, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0 || bh <= 0) return (int)cudaErrorInvalidValue;
  const int nb = 1 + (H - 1) / bh;
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, nb, C);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cas_blocked_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(top),
      static_cast<const float*>(bot), static_cast<uint8_t*>(out), H, W, bh, nb, sharpen);
  return (int)cudaGetLastError();
}
