// The cuFFT form's two spectrum passes (fft/cufft.py), one kernel each
// (Hopper, sm_90a):
//
//   vkr_spectrum_shift  the frame's r2c half spectrum relocated into the
//                       kept columns of the upscaled frame's spectrum, zero
//                       band included, written column-major (y innermost)
//                       for the y inverse
//   vkr_spectrum_pad    the y inverse's output, column-major, written back
//                       row-major and zero-padded to the C2R's W/2 + 1
//                       columns, the imaginary part of column 0 zeroed
//
// Replace no TPU kernel: the JAX package's u = 2 routes never form the
// spectrum (their GEMM banks hold the whole chain), and its reference tier
// lets XLA place the slices (ops/spectrum.py::assemble_big_spectrum).  The
// shift is the port's counterpart of VkResample's own shift shader
// (VkResample.cpp:476-548), which moves the negative-frequency rows of the
// forward transform's output to the far edge of the big buffer.
//
// Why column-major in between.  torch.fft runs a transform along y of a
// row-major (n, H, kx) tensor by copying it to (n, kx, H) first (cuFFT
// wants one batch stride), and hands back its output in that layout; the
// C2R's zero padding then copies it back.  In PyTorch those are two
// strided copies of complex values, plus a fill of the padding and the
// shift's own fill and two copies.  Here the shift writes the layout the
// y transform reads as it is, and the pad writes the C2R's input in one
// pass: two passes in all.
//
// What they compute.  Shift: F contiguous complex64 (n, h, wf) (wf = w/2 +
// 1, the forward R2C's columns) -> G complex64 stored (n, kx, H), with
//   G[., c, r] = F[., r, c]            for r < klo
//              = 0                     for klo <= r < H - khi
//              = F[., r - (H - h), c]  for r >= H - khi
// for c < kx (<= wf): the bins ops/spectrum.py keeps, the columns at and
// past kx (the source Nyquist column at u = 2) dropped.  Pad: g complex64
// stored (n, kx, H) -> P contiguous complex64 (n, H, wp), P[., r, c] =
// g[., c, r] for c < kx with Im zeroed at c = 0 (pipeline/upscale.py::
// _irfft2 zeroes it: the relocated y-Nyquist row leaves column 0
// non-Hermitian), 0 for kx <= c < wp.
//
// Bound on this card: copies, 8 bytes a bin.  At the flagship batch of 8
// frames (n = 24, h = 1024, wf = 1025, H = 2048, kx = 1024, wp = 2049) the
// shift reads 201 MB and writes 403 MB (~0.18 ms at 3.35 TB/s), the pad
// reads 403 MB and writes 806 MB (~0.36 ms).
//
// Design.  Both transpose through a 32 x 32 tile of float2 in shared
// memory (one padding column against bank conflicts), a block of 32 x 8
// threads, four rows each: the global reads and writes are 256 contiguous
// bytes a warp on both sides.  A tile in the zero band (shift) or past kx
// (pad) stores zeros without reading.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // blockDim.y

__global__ void __launch_bounds__(kTile * kRowsPerPass)
spectrum_shift_kernel(const float2* __restrict__ F, float2* __restrict__ G, int h, int wf,
                      int H, int kx, int klo, int khi) {
  __shared__ float2 tile[kTile][kTile + 1];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const size_t n = blockIdx.z;
  const bool band = r0 >= klo && r0 + kTile <= H - khi;  // the whole tile is zero
  if (!band) {
    const int c = c0 + threadIdx.x;
    for (int k = threadIdx.y; k < kTile; k += kRowsPerPass) {
      const int r = r0 + k;
      int src = -1;
      if (r < klo) src = r;
      else if (r >= H - khi && r < H) src = r - (H - h);
      tile[k][threadIdx.x] = (src >= 0 && c < kx) ? F[(n * h + src) * (size_t)wf + c]
                                                  : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
  }
  const int r = r0 + threadIdx.x;
  if (r >= H) return;
  for (int k = threadIdx.y; k < kTile; k += kRowsPerPass) {
    const int c = c0 + k;
    if (c < kx)
      G[(n * kx + c) * (size_t)H + r] = band ? make_float2(0.0f, 0.0f) : tile[threadIdx.x][k];
  }
}

__global__ void __launch_bounds__(kTile * kRowsPerPass)
spectrum_pad_kernel(const float2* __restrict__ g, float2* __restrict__ P, int H, int kx,
                    int wp) {
  __shared__ float2 tile[kTile][kTile + 1];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const size_t n = blockIdx.z;
  const bool pad = c0 >= kx;  // the whole tile is padding
  if (!pad) {
    const int r = r0 + threadIdx.x;
    for (int k = threadIdx.y; k < kTile; k += kRowsPerPass) {
      const int c = c0 + k;
      float2 v = make_float2(0.0f, 0.0f);
      if (c < kx && r < H) {
        v = g[(n * kx + c) * (size_t)H + r];
        if (c == 0) v.y = 0.0f;
      }
      tile[k][threadIdx.x] = v;
    }
    __syncthreads();
  }
  const int c = c0 + threadIdx.x;
  if (c >= wp) return;
  for (int k = threadIdx.y; k < kTile; k += kRowsPerPass) {
    const int r = r0 + k;
    if (r < H)
      P[(n * H + r) * (size_t)wp + c] = pad ? make_float2(0.0f, 0.0f) : tile[threadIdx.x][k];
  }
}

}  // namespace

// C entry points (loaded with ctypes): each launches on `stream`, does not
// synchronise and returns the cudaError_t of the launch.
//
// F: contiguous complex64 (n, h, wf); G: complex64 (n, kx, H), contiguous;
// 0 < kx <= wf, klo + khi <= min(h, H); n <= 65535 (grid planes).
extern "C" int vkr_spectrum_shift(const void* F, void* G, int n, int h, int wf, int H, int kx,
                                  int klo, int khi, void* stream) {
  if (n <= 0 || h <= 0 || H <= 0 || kx <= 0 || kx > wf || n > 65535 || klo < 0 || khi < 0 ||
      klo + khi > h || klo + khi > H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((kx + kTile - 1) / kTile, (H + kTile - 1) / kTile, n);
  spectrum_shift_kernel<<<grid, dim3(kTile, kRowsPerPass), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(F), static_cast<float2*>(G), h, wf, H, kx, klo, khi);
  return (int)cudaGetLastError();
}

// g: complex64 (n, kx, H), contiguous; P: contiguous complex64 (n, H, wp);
// 0 < kx <= wp; n <= 65535.
extern "C" int vkr_spectrum_pad(const void* g, void* P, int n, int H, int kx, int wp,
                                void* stream) {
  if (n <= 0 || H <= 0 || kx <= 0 || kx > wp || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((wp + kTile - 1) / kTile, (H + kTile - 1) / kTile, n);
  spectrum_pad_kernel<<<grid, dim3(kTile, kRowsPerPass), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<float2*>(P), H, kx, wp);
  return (int)cudaGetLastError();
}
