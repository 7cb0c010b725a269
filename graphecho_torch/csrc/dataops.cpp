// Host C++ data-pipeline kernels of graphecho_torch: a copy of the JAX
// package's `native/dataops.cpp`, with the same C ABI, so that both packages
// compute the same bytes.
//
// The reference delegates host-side preprocessing to MONAI/cv2/skimage
// (resize/crop in datasets/camus.py:142-158, polygon rasterization in
// datasets/echo.py:243-255). Those are the per-sample CPU hot loops of the
// input pipeline; here they are plain C++ exposed through a C ABI and loaded
// with ctypes. Multi-frame batches are parallelized across a small thread
// pool; ctypes releases the GIL for the call, so the loaders' threads run
// them side by side.
//
// Build: graphecho_torch/data/native.py (g++ -O3 -march=native -std=c++17
// -shared -fPIC, into graphecho_torch/_build/ at first use).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

template <typename T>
void nearest_resize_one(const T* src, int64_t h, int64_t w, int64_t c,
                        T* dst, int64_t oh, int64_t ow) {
  // torch F.interpolate(mode='nearest') semantics: src = floor(i * in / out)
  std::vector<int64_t> xmap(ow);
  for (int64_t x = 0; x < ow; ++x) {
    int64_t sx = static_cast<int64_t>(std::floor(x * (double)w / ow));
    xmap[x] = std::min(sx, w - 1);
  }
  for (int64_t y = 0; y < oh; ++y) {
    int64_t sy = static_cast<int64_t>(std::floor(y * (double)h / oh));
    sy = std::min(sy, h - 1);
    const T* src_row = src + sy * w * c;
    T* dst_row = dst + y * ow * c;
    for (int64_t x = 0; x < ow; ++x) {
      std::memcpy(dst_row + x * c, src_row + xmap[x] * c, sizeof(T) * c);
    }
  }
}

void parallel_for(int64_t n, const std::function<void(int64_t)>& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  int64_t n_threads = std::min<int64_t>(hw, n);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  for (int64_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// src: (N, H, W, C) contiguous; dst: (N, OH, OW, C). dtype: 0=f32, 1=u8.
void ge_nearest_resize_batch(const void* src, int64_t n, int64_t h, int64_t w,
                             int64_t c, void* dst, int64_t oh, int64_t ow,
                             int dtype) {
  parallel_for(n, [&](int64_t i) {
    if (dtype == 0) {
      nearest_resize_one(reinterpret_cast<const float*>(src) + i * h * w * c,
                         h, w, c,
                         reinterpret_cast<float*>(dst) + i * oh * ow * c, oh,
                         ow);
    } else {
      nearest_resize_one(reinterpret_cast<const uint8_t*>(src) + i * h * w * c,
                         h, w, c,
                         reinterpret_cast<uint8_t*>(dst) + i * oh * ow * c, oh,
                         ow);
    }
  });
}

// Even-odd scanline polygon fill. ys/xs: polygon vertices (double, size n).
// out: (h, w) float32 zeroed by the caller; interior set to 1.
void ge_polygon_mask(const double* ys, const double* xs, int64_t n, int64_t h,
                     int64_t w, float* out) {
  if (n < 3) return;
  std::vector<double> nodes;
  nodes.reserve(n);
  for (int64_t row = 0; row < h; ++row) {
    double y = static_cast<double>(row);
    nodes.clear();
    int64_t j = n - 1;
    for (int64_t i = 0; i < n; ++i) {
      if ((ys[i] <= y && y < ys[j]) || (ys[j] <= y && y < ys[i])) {
        double t = (y - ys[i]) / (ys[j] - ys[i]);
        nodes.push_back(xs[i] + t * (xs[j] - xs[i]));
      }
      j = i;
    }
    std::sort(nodes.begin(), nodes.end());
    for (size_t k = 0; k + 1 < nodes.size(); k += 2) {
      int64_t x0 = static_cast<int64_t>(std::ceil(nodes[k]));
      int64_t x1 = static_cast<int64_t>(std::floor(nodes[k + 1]));
      x0 = std::max<int64_t>(x0, 0);
      x1 = std::min<int64_t>(x1, w - 1);
      for (int64_t x = x0; x <= x1; ++x) out[row * w + x] = 1.0f;
    }
  }
}

// u8 (N,) -> f32 (N,) scaled by 1/255 (the reference's `/255.0`).
void ge_normalize_u8(const uint8_t* src, int64_t n, float* dst) {
  constexpr float kInv = 1.0f / 255.0f;
  parallel_for((n + (1 << 20) - 1) >> 20, [&](int64_t blk) {
    int64_t lo = blk << 20;
    int64_t hi = std::min(n, lo + (int64_t)(1 << 20));
    for (int64_t i = lo; i < hi; ++i) dst[i] = src[i] * kInv;
  });
}

}  // extern "C"
