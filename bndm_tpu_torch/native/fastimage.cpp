// Native image data plane: fused resize + center-crop + hflip + normalize.
//
// TPU-native stand-in for the host-side work torchvision's C++ ops do in the
// reference's DataLoader workers (Resize/CenterCrop/Flip/ToTensor,
// iadb_bn.py:443-444): one pass from decoded uint8 HWC to the float32 CHW
// tensor the trainer feeds, with PIL-compatible antialiased bilinear
// (triangle-filter) resampling. Compiled to a shared library and loaded via
// ctypes (no pybind11 in this image); the Python pipeline falls back to
// PIL/numpy when the toolchain is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Coeffs {
  // per output pixel: [bound_lo, n] and weights
  std::vector<int> lo;
  std::vector<int> n;
  std::vector<std::vector<float>> w;
};

// PIL-style triangle (bilinear) filter with antialias support scaling.
Coeffs build_coeffs(int in_size, int out_size) {
  Coeffs c;
  c.lo.resize(out_size);
  c.n.resize(out_size);
  c.w.resize(out_size);
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // bilinear support = 1
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    int n = hi - lo;
    c.lo[i] = lo;
    c.n[i] = n;
    c.w[i].resize(n);
    double total = 0.0;
    for (int k = 0; k < n; ++k) {
      double x = (lo + k + 0.5 - center) / filterscale;
      double v = (x < 0) ? -x : x;
      double weight = (v < 1.0) ? 1.0 - v : 0.0;
      c.w[i][k] = static_cast<float>(weight);
      total += weight;
    }
    if (total > 0) {
      for (int k = 0; k < n; ++k) c.w[i][k] = static_cast<float>(c.w[i][k] / total);
    }
  }
  return c;
}

}  // namespace

extern "C" {

// src: uint8 HWC (h, w, ch). out: float32 CHW (ch, res, res) in [0, 1].
// Pipeline: resize shorter side -> res (aspect kept, rounded), crop res x res
// at (crop_top, crop_left) — pass -1/-1 for center crop (the torchvision
// CenterCrop default; explicit offsets implement RandomCrop, the HF
// train_unconditional behavior when --center_crop is absent,
// ddim_diffusers.py:539) — optional hflip, normalize, transpose.
void transform_u8_to_chw_f32_v2(const uint8_t* src, int h, int w, int ch,
                                int res, int hflip, int crop_top,
                                int crop_left, float* out) {
  int nw, nh;
  if (w <= h) {
    nw = res;
    nh = std::max(res, static_cast<int>(std::lround(static_cast<double>(h) * res / w)));
  } else {
    nh = res;
    nw = std::max(res, static_cast<int>(std::lround(static_cast<double>(w) * res / h)));
  }

  // horizontal pass: (h, w, ch) -> (h, nw, ch), float
  Coeffs cx = build_coeffs(w, nw);
  std::vector<float> tmp(static_cast<size_t>(h) * nw * ch);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * ch;
    float* trow = tmp.data() + static_cast<size_t>(y) * nw * ch;
    for (int x = 0; x < nw; ++x) {
      for (int d = 0; d < ch; ++d) {
        float acc = 0.f;
        const int lo = cx.lo[x], n = cx.n[x];
        const float* wt = cx.w[x].data();
        for (int k = 0; k < n; ++k) acc += wt[k] * row[(lo + k) * ch + d];
        trow[x * ch + d] = acc;
      }
    }
  }

  // vertical pass fused with crop/flip/normalize/transpose.
  Coeffs cy = build_coeffs(h, nh);
  int left = (crop_left >= 0) ? crop_left : (nw - res) / 2;
  int top = (crop_top >= 0) ? crop_top : (nh - res) / 2;
  left = std::min(std::max(left, 0), nw - res);
  top = std::min(std::max(top, 0), nh - res);
  for (int yo = 0; yo < res; ++yo) {
    const int y = top + yo;
    const int lo = cy.lo[y], n = cy.n[y];
    const float* wt = cy.w[y].data();
    for (int xo = 0; xo < res; ++xo) {
      const int x = left + (hflip ? (res - 1 - xo) : xo);
      for (int d = 0; d < ch; ++d) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k)
          acc += wt[k] * tmp[(static_cast<size_t>(lo + k) * nw + x) * ch + d];
        // PIL rounds to uint8 between resize and ToTensor; reproduce that
        float v = std::min(std::max(acc, 0.f), 255.f);
        v = std::floor(v + 0.5f);
        out[(static_cast<size_t>(d) * res + yo) * res + xo] = v / 255.0f;
      }
    }
  }
}

// original center-crop entry point (kept for ABI stability)
void transform_u8_to_chw_f32(const uint8_t* src, int h, int w, int ch, int res,
                             int hflip, float* out) {
  transform_u8_to_chw_f32_v2(src, h, w, ch, res, hflip, -1, -1, out);
}

// batched variant for thread-pool-free bulk transforms
void transform_batch_u8_to_chw_f32(const uint8_t* const* srcs, const int* hs,
                                   const int* ws, int ch, int res,
                                   const int* hflips, int count, float* out) {
  const size_t stride = static_cast<size_t>(ch) * res * res;
  for (int i = 0; i < count; ++i) {
    transform_u8_to_chw_f32(srcs[i], hs[i], ws[i], ch, res, hflips[i], out + i * stride);
  }
}

}  // extern "C"
