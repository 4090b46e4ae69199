// Native JPEG decode -> resize -> normalize, fused per image and
// multi-threaded over the batch (the remaining host-side hot path from
// SURVEY.md §2.9 escape #11: the reference decodes via PIL/cv2 one
// sample at a time in Python).  Links against the system libjpeg.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread jpeg_ops.cpp -ljpeg
//        -o libjpeg_ops.so

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// same bilinear + normalize kernel as image_ops.cpp (half-pixel centers,
// cv2 INTER_LINEAR convention) — kept in-file so each .so is
// self-contained for the ctypes loader
inline void resize_normalize_one(const uint8_t* src, int sh, int sw, int c,
                                 float* dst, int dh, int dw,
                                 const float* mean, const float* stddev) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  std::vector<float> inv_std(c);
  for (int k = 0; k < c; ++k) inv_std[k] = 1.0f / stddev[k];

  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    if (fy < 0) wy = 0.0f;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * c;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * c;
    float* out_row = dst + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      if (fx < 0) wx = 0.0f;
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      const uint8_t* p00 = row0 + static_cast<size_t>(x0) * c;
      const uint8_t* p01 = row0 + static_cast<size_t>(x1) * c;
      const uint8_t* p10 = row1 + static_cast<size_t>(x0) * c;
      const uint8_t* p11 = row1 + static_cast<size_t>(x1) * c;
      for (int k = 0; k < c; ++k) {
        float v = w00 * p00[k] + w01 * p01[k] + w10 * p10[k] + w11 * p11[k];
        out_row[static_cast<size_t>(x) * c + k] = (v - mean[k]) * inv_std[k];
      }
    }
  }
}

// decode one JPEG into an RGB uint8 buffer; returns false on failure
bool decode_one(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  const int c = cinfo.output_components;  // 3 after JCS_RGB
  out->resize(static_cast<size_t>(*h) * *w * c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
        static_cast<size_t>(cinfo.output_scanline) * *w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

// data: concatenated jpeg streams; offsets: n+1 byte offsets.
// out: [n, dh, dw, 3] float32.  Returns 0 on success, or 1-based index
// of the first image that failed to decode.
int decode_resize_normalize_batch(const uint8_t* data,
                                  const int64_t* offsets, int n,
                                  float* out, int dh, int dw,
                                  const float* mean, const float* stddev,
                                  int threads) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 1;
  }
  threads = std::min(threads, n);
  std::vector<int> status(n, 0);
  auto work = [&](int t) {
    std::vector<uint8_t> rgb;
    for (int i = t; i < n; i += threads) {
      int h = 0, w = 0;
      const uint8_t* buf = data + offsets[i];
      size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
      if (!decode_one(buf, len, &rgb, &h, &w)) {
        status[i] = 1;
        continue;
      }
      resize_normalize_one(rgb.data(), h, w, 3,
                           out + static_cast<size_t>(i) * dh * dw * 3,
                           dh, dw, mean, stddev);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i) {
    if (status[i]) return i + 1;
  }
  return 0;
}

// Decode a single JPEG to uint8 RGB.  Caller passes a buffer of
// max_h*max_w*3; actual dims written to h/w.  Returns 0 ok, 1 decode
// failure, 2 buffer too small.
int decode_jpeg(const uint8_t* buf, int64_t len, uint8_t* out,
                int64_t capacity, int* h, int* w) {
  std::vector<uint8_t> rgb;
  if (!decode_one(buf, static_cast<size_t>(len), &rgb, h, w)) return 1;
  if (static_cast<int64_t>(rgb.size()) > capacity) return 2;
  std::memcpy(out, rgb.data(), rgb.size());
  return 0;
}

}  // extern "C"
