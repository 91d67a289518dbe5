// Native host-side image resize for far_tpu_torch's data layer.
//
// The bilinear resize of far_tpu/data/native/preprocess.cpp, copied so
// both packages resize with the same code (the port binds no other entry
// point of that file). The reference reaches C++ for its image IO through
// OpenCV (cv2.imread/resize, crockwell/far:
// mp3d_loftr/src/utils/dataset.py); this is the first-party equivalent:
// a batched bilinear resize over OpenMP threads, behind a plain C ABI
// bound with ctypes.
//
// Built at first use by far_tpu_torch/data/native/__init__.py:
//   g++ -O3 -fopenmp -shared -fPIC preprocess.cpp -o libfar_preprocess_<hash>.so

#include <cstdint>
#include <algorithm>

namespace {

// Bilinear sample with half-pixel centers (matches PIL / jax.image).
inline float sample_bilinear(const uint8_t* src, int h, int w, int c,
                             int ch, float y, float x) {
    // map output pixel center to input coordinates
    float fy = y - 0.5f;
    float fx = x - 0.5f;
    int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1.0f);
    int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1.0f);
    float wy = fy - y0;
    float wx = fx - x0;
    int y1 = y0 + 1, x1 = x0 + 1;
    y0 = std::min(std::max(y0, 0), h - 1);
    y1 = std::min(std::max(y1, 0), h - 1);
    x0 = std::min(std::max(x0, 0), w - 1);
    x1 = std::min(std::max(x1, 0), w - 1);
    const float v00 = src[(y0 * w + x0) * c + ch];
    const float v01 = src[(y0 * w + x1) * c + ch];
    const float v10 = src[(y1 * w + x0) * c + ch];
    const float v11 = src[(y1 * w + x1) * c + ch];
    return (1 - wy) * ((1 - wx) * v00 + wx * v01) +
           wy * ((1 - wx) * v10 + wx * v11);
}

}  // namespace

extern "C" {

// Resize a batch of HWC uint8 images with bilinear filtering.
// src: (n, h, w, c) contiguous; dst: (n, oh, ow, c).
void far_resize_bilinear_u8(const uint8_t* src, uint8_t* dst,
                            int n, int h, int w, int c,
                            int oh, int ow) {
    const float sy = static_cast<float>(h) / oh;
    const float sx = static_cast<float>(w) / ow;
#pragma omp parallel for collapse(2) schedule(static)
    for (int b = 0; b < n; ++b) {
        for (int oy = 0; oy < oh; ++oy) {
            const uint8_t* s = src + static_cast<int64_t>(b) * h * w * c;
            uint8_t* d = dst + ((static_cast<int64_t>(b) * oh + oy) * ow) * c;
            const float y = (oy + 0.5f) * sy;
            for (int ox = 0; ox < ow; ++ox) {
                const float x = (ox + 0.5f) * sx;
                for (int ch = 0; ch < c; ++ch) {
                    float v = sample_bilinear(s, h, w, c, ch, y, x);
                    d[ox * c + ch] =
                        static_cast<uint8_t>(std::min(std::max(v + 0.5f, 0.0f),
                                                      255.0f));
                }
            }
        }
    }
}

}  // extern "C"
