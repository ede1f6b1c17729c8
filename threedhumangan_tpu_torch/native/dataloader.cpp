// Native data-loader core of the port: the per-item image hot loop of the
// SHHQ dataset (data/dataset.py), bound by ctypes in data/native.py, which
// builds it with g++ on first use and falls back to numpy without a
// compiler.  A copy of threedhumangan_tpu/native/dataloader.cpp (the
// normalize, the resizes and the label shift, unchanged) plus the PNG row
// unfilter of data/utils.py::read_png.
//
// All functions operate on caller-allocated buffers; images are HWC uint8
// in, float32 out.  Plain C ABI, no Python API.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>

extern "C" {

// uint8 HWC -> float32 HWC in [-1, 1]; pixels where mask == 0 become white
// (+1.0), the dataset's background compositing.
void normalize_masked_image(
    const uint8_t* rgb, const uint8_t* mask, float* out,
    int64_t h, int64_t w, int64_t c) {
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; ++i) {
    const bool bg = (mask != nullptr) && (mask[i] == 0);
    for (int64_t k = 0; k < c; ++k) {
      out[i * c + k] = bg ? 1.0f : (rgb[i * c + k] * (1.0f / 127.5f) - 1.0f);
    }
  }
}

// Nearest-neighbour resize, uint8 HWC (labels / masks).
void resize_nearest_u8(
    const uint8_t* src, uint8_t* dst,
    int64_t sh, int64_t sw, int64_t dh, int64_t dw, int64_t c) {
  for (int64_t y = 0; y < dh; ++y) {
    // sample at (y + 0.5) * scale
    int64_t sy = std::min<int64_t>(sh - 1, (int64_t)(((double)y + 0.5) * sh / dh));
    for (int64_t x = 0; x < dw; ++x) {
      int64_t sx = std::min<int64_t>(sw - 1, (int64_t)(((double)x + 0.5) * sw / dw));
      std::memcpy(dst + (y * dw + x) * c, src + (sy * sw + sx) * c, c);
    }
  }
}

// Bilinear resize, uint8 HWC -> uint8 HWC (half-pixel centers).
void resize_bilinear_u8(
    const uint8_t* src, uint8_t* dst,
    int64_t sh, int64_t sw, int64_t dh, int64_t dw, int64_t c) {
  const double scale_y = (double)sh / dh;
  const double scale_x = (double)sw / dw;
  for (int64_t y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * scale_y - 0.5;
    int64_t y0 = (int64_t)fy;
    if (fy < 0) { fy = 0; y0 = 0; }
    int64_t y1 = std::min<int64_t>(y0 + 1, sh - 1);
    const double wy = fy - y0;
    for (int64_t x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * scale_x - 0.5;
      int64_t x0 = (int64_t)fx;
      if (fx < 0) { fx = 0; x0 = 0; }
      int64_t x1 = std::min<int64_t>(x0 + 1, sw - 1);
      const double wx = fx - x0;
      for (int64_t k = 0; k < c; ++k) {
        const double v00 = src[(y0 * sw + x0) * c + k];
        const double v01 = src[(y0 * sw + x1) * c + k];
        const double v10 = src[(y1 * sw + x0) * c + k];
        const double v11 = src[(y1 * sw + x1) * c + k];
        const double top = v00 + (v01 - v00) * wx;
        const double bot = v10 + (v11 - v10) * wx;
        double v = top + (bot - top) * wy;
        v = v < 0 ? 0 : (v > 255 ? 255 : v);
        dst[(y * dw + x) * c + k] = (uint8_t)(v + 0.5);
      }
    }
  }
}

// Shift segmentation labels: 0 stays reserved for "fake", foreground labels
// shift +1, background becomes 1.  int64 in place.
void shift_segment_labels(int64_t* seg, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    seg[i] = seg[i] > 0 ? seg[i] + 1 : 1;
  }
}

// Undo the PNG row filters (PNG spec section 9): ``raw`` holds h rows of one
// filter-type byte and ``stride`` filtered bytes (the inflated IDAT
// stream), ``bpp`` the bytes a pixel takes (at least 1).  Writes the h x
// stride unfiltered bytes to ``out``.  Returns 0, or the row + 1 of the
// first unknown filter type.
int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1) + 1;
    const uint8_t type = raw[y * (stride + 1)];
    uint8_t* row = out + y * stride;
    const uint8_t* prev = y ? row - stride : nullptr;
    switch (type) {
      case 0:  // None
        std::memcpy(row, in, stride);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
          row[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
