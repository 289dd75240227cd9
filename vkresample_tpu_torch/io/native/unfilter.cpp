// PNG scanline unfiltering for the port's stdlib-zlib PNG reader
// (vkresample_tpu_torch/io/png.py), which runs where libpng is missing.
// Plain C interface, no libpng: built with g++ at first use and called
// through ctypes, which releases the GIL, so several threads decode at once.
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Undo the filters of one image or Adam7 pass: `lines` holds rows
// scanlines of 1 + stride bytes, each led by its filter type; `out` gets
// rows x stride bytes.  The first row's prior row is zeros; a filter unit
// is bpp bytes.  Returns -1, or the index of the first row whose filter
// type is not 0..4 (that row and the rows after it are not written).
int vkr_png_unfilter(const uint8_t* lines, int rows, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src = lines + (size_t)y * (stride + 1) + 1;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    switch (src[-1]) {
      case 0:  // None
        memcpy(cur, src, stride);
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i) cur[i] = src[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i) cur[i] = src[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Avg
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = src[i] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          cur[i] = src[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

}  // extern "C"
