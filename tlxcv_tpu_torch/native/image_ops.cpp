// Native host-side input pipeline ops for tlxcv_tpu_torch (the same source
// as tlxcv_tpu/native/image_ops.cpp).
//
// The reference's data path is per-sample Python (cv2 resize, numpy
// normalize, PIL decode) — SURVEY.md §2.9 escape #11.  This module fuses
// resize(bilinear, half-pixel centers, cv2-compatible) + normalize
// ((x - mean) / std) + layout into ONE multi-threaded C++ pass over the
// batch, writing float32 NHWC ready for device transfer.  Exposed via
// ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread image_ops.cpp
//        -o libimage_ops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// bilinear sample with half-pixel centers (cv2 INTER_LINEAR convention)
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
      float* out = out_row + static_cast<size_t>(x) * c;
      for (int k = 0; k < c; ++k) {
        float v = w00 * p00[k] + w01 * p01[k] + w10 * p10[k] + w11 * p11[k];
        out[k] = (v - mean[k]) * inv_std[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Batch fused resize+normalize. src: B contiguous HxWxC uint8 images.
// dst: B x dh x dw x c float32.  threads<=0 -> hardware_concurrency.
void resize_normalize_batch(const uint8_t* src, int batch, int sh, int sw,
                            int c, float* dst, int dh, int dw,
                            const float* mean, const float* stddev,
                            int threads) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  threads = std::min(threads, batch);
  const size_t src_stride = static_cast<size_t>(sh) * sw * c;
  const size_t dst_stride = static_cast<size_t>(dh) * dw * c;

  auto work = [&](int begin, int end) {
    for (int b = begin; b < end; ++b) {
      resize_normalize_one(src + b * src_stride, sh, sw, c,
                           dst + b * dst_stride, dh, dw, mean, stddev);
    }
  };
  if (threads <= 1) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  int per = (batch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int begin = t * per;
    int end = std::min(begin + per, batch);
    if (begin >= end) break;
    pool.emplace_back(work, begin, end);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
