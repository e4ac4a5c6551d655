// Mirrors yolo2_light_tpu/native/resize.cpp: a copy for the port.
// Native darknet-exact separable bilinear resize.
//
// Semantics match the reference resize_image (src/additionally.c:3021-3064):
// scale = (in-1)/(out-1), last output column / row copies the source edge, float32
// arithmetic. Layout here is HWC float32 (the framework's host-side image layout);
// the reference is CHW — per-pixel math is identical, only the loop order differs.
//
// Exposed C ABI (ctypes):
//   resize_hwc(src[H*W*C], sh, sw, c, dst[h*w*C], dh, dw)

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

void resize_hwc(const float* src, int64_t sh, int64_t sw, int64_t c,
                float* dst, int64_t dh, int64_t dw) {
  const float w_scale = dw > 1 ? static_cast<float>(sw - 1) / (dw - 1) : 0.0f;
  const float h_scale = dh > 1 ? static_cast<float>(sh - 1) / (dh - 1) : 0.0f;

  // horizontal pass: [sh, dw, c]
  std::vector<float> part(static_cast<size_t>(sh) * dw * c);
  for (int64_t x = 0; x < dw; ++x) {
    if (x == dw - 1 || sw == 1) {
      for (int64_t r = 0; r < sh; ++r)
        for (int64_t ch = 0; ch < c; ++ch)
          part[(r * dw + x) * c + ch] = src[(r * sw + (sw - 1)) * c + ch];
    } else {
      const float sx = x * w_scale;
      const int64_t ix = static_cast<int64_t>(sx);
      const float dx = sx - ix;
      for (int64_t r = 0; r < sh; ++r) {
        const float* s0 = src + (r * sw + ix) * c;
        const float* s1 = src + (r * sw + ix + 1) * c;
        float* d = part.data() + (r * dw + x) * c;
        for (int64_t ch = 0; ch < c; ++ch)
          d[ch] = (1.0f - dx) * s0[ch] + dx * s1[ch];
      }
    }
  }

  // vertical pass: [dh, dw, c]
  for (int64_t y = 0; y < dh; ++y) {
    const float sy = y * h_scale;
    const int64_t iy = static_cast<int64_t>(sy);
    const float dy = sy - iy;
    const float* p0 = part.data() + iy * dw * c;
    float* d = dst + y * dw * c;
    for (int64_t i = 0; i < dw * c; ++i) d[i] = (1.0f - dy) * p0[i];
    if (y == dh - 1 || sh == 1) continue;
    const float* p1 = part.data() + (iy + 1) * dw * c;
    for (int64_t i = 0; i < dw * c; ++i) d[i] += dy * p1[i];
  }
}

}  // extern "C"
