// Native host-side data-path kernels of the PyTorch port (a copy of the JAX
// package's native/midd_native.cc, which the port may not import from).
//
// The reference's input pipeline is PIL + torchvision transforms on Python
// threads (NafNet/NafnetModel.py:46-156). These C++ kernels are the GIL-free
// equivalents that midd_tpu_torch.train.data uses where asked to
// (``load_image(use_native=True)`` or MIDD_TPU_NATIVE=1), built by
// midd_tpu_torch/native.py and loaded through ctypes:
//
//  - resize_bicubic_u8 / resize_bicubic_f32: PIL-style separable convolution
//    resampling with the Catmull-Rom-like a=-0.5 cubic kernel and antialias
//    support scaling on downscale (matches PIL.Image.resize(BICUBIC)).
//  - augment_pair_f32: paired flips / brightness / contrast / additive
//    Gaussian noise on fp32 [0,1] images (NafNet:102-144 semantics).
//
// Build (native.py does it at first use, into midd_tpu_torch/build/):
//   g++ -O3 -shared -fPIC -o libmidd_native_<hash>.so midd_native.cc

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

inline double cubic(double x) {
  // PIL's bicubic filter (a = -0.5)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Taps {
  std::vector<int> start;     // first source index per output pixel
  std::vector<int> count;     // number of taps
  std::vector<double> weight; // taps, row-major [out, max_count]
  int max_count = 0;
};

Taps build_taps(int in_size, int out_size) {
  Taps taps;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale; // bicubic support = 2
  taps.max_count = static_cast<int>(std::ceil(support) * 2 + 1);
  taps.start.resize(out_size);
  taps.count.resize(out_size);
  taps.weight.assign(static_cast<size_t>(out_size) * taps.max_count, 0.0);

  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    taps.start[i] = lo;
    taps.count[i] = hi - lo;
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double w = cubic((j - center + 0.5) / filterscale);
      taps.weight[static_cast<size_t>(i) * taps.max_count + (j - lo)] = w;
      sum += w;
    }
    if (sum != 0.0) {
      for (int k = 0; k < taps.count[i]; ++k)
        taps.weight[static_cast<size_t>(i) * taps.max_count + k] /= sum;
    }
  }
  return taps;
}

template <typename Src>
void resize_bicubic_impl(const Src* src, int h, int w, float* dst, int oh, int ow,
                         bool quantize_intermediate) {
  const Taps tx = build_taps(w, ow);
  const Taps ty = build_taps(h, oh);

  // horizontal pass: (h, w) -> (h, ow). PIL quantises the intermediate to
  // uint8 between passes for 8-bit images; replicate for parity.
  std::vector<float> tmp(static_cast<size_t>(h) * ow);
  for (int y = 0; y < h; ++y) {
    const Src* row = src + static_cast<size_t>(y) * w;
    for (int x = 0; x < ow; ++x) {
      double acc = 0.0;
      const double* wts = &tx.weight[static_cast<size_t>(x) * tx.max_count];
      const int s = tx.start[x];
      for (int k = 0; k < tx.count[x]; ++k) acc += wts[k] * static_cast<double>(row[s + k]);
      if (quantize_intermediate)
        acc = std::min(255.0, std::max(0.0, std::round(acc)));
      tmp[static_cast<size_t>(y) * ow + x] = static_cast<float>(acc);
    }
  }
  // vertical pass: (h, ow) -> (oh, ow)
  for (int y = 0; y < oh; ++y) {
    const double* wts = &ty.weight[static_cast<size_t>(y) * ty.max_count];
    const int s = ty.start[y];
    for (int x = 0; x < ow; ++x) {
      double acc = 0.0;
      for (int k = 0; k < ty.count[y]; ++k)
        acc += wts[k] * tmp[static_cast<size_t>(s + k) * ow + x];
      dst[static_cast<size_t>(y) * ow + x] = static_cast<float>(acc);
    }
  }
}

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  float uniform() { return static_cast<float>((next() >> 11) * (1.0 / 9007199254740992.0)); }
  float gauss() {
    // Box-Muller
    float u1 = std::max(uniform(), 1e-12f), u2 = uniform();
    return std::sqrt(-2.0f * std::log(u1)) * std::cos(6.2831853f * u2);
  }
};

} // namespace

extern "C" {

void resize_bicubic_u8(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow) {
  std::vector<float> out(static_cast<size_t>(oh) * ow);
  resize_bicubic_impl(src, h, w, out.data(), oh, ow, true);
  for (size_t i = 0; i < out.size(); ++i) {
    const float v = out[i];
    dst[i] = static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, std::round(v))));
  }
}

void resize_bicubic_f32(const float* src, int h, int w, float* dst, int oh, int ow) {
  resize_bicubic_impl(src, h, w, dst, oh, ow, false);
}

// flags: bit0 hflip, bit1 vflip. brightness/contrast of 1.0 = no-op.
// noise_std > 0 adds Gaussian noise to the noisy image only.
void augment_pair_f32(float* clean, float* noisy, int h, int w, int flags,
                      float brightness, float contrast, float noise_std,
                      uint64_t seed) {
  const size_t n = static_cast<size_t>(h) * w;

  auto hflip = [&](float* img) {
    for (int y = 0; y < h; ++y) {
      float* row = img + static_cast<size_t>(y) * w;
      std::reverse(row, row + w);
    }
  };
  auto vflip = [&](float* img) {
    for (int y = 0; y < h / 2; ++y)
      std::swap_ranges(img + static_cast<size_t>(y) * w,
                       img + static_cast<size_t>(y + 1) * w,
                       img + static_cast<size_t>(h - 1 - y) * w);
  };

  if (flags & 1) { hflip(clean); hflip(noisy); }
  if (flags & 2) { vflip(clean); vflip(noisy); }

  if (brightness != 1.0f) {
    for (size_t i = 0; i < n; ++i) {
      clean[i] = std::min(1.0f, std::max(0.0f, clean[i] * brightness));
      noisy[i] = std::min(1.0f, std::max(0.0f, noisy[i] * brightness));
    }
  }

  if (contrast != 1.0f) {
    double mc = 0.0, mn = 0.0;
    for (size_t i = 0; i < n; ++i) { mc += clean[i]; mn += noisy[i]; }
    const float meanc = static_cast<float>(mc / n), meann = static_cast<float>(mn / n);
    for (size_t i = 0; i < n; ++i) {
      clean[i] = std::min(1.0f, std::max(0.0f, (clean[i] - meanc) * contrast + meanc));
      noisy[i] = std::min(1.0f, std::max(0.0f, (noisy[i] - meann) * contrast + meann));
    }
  }

  if (noise_std > 0.0f) {
    XorShift rng(seed);
    for (size_t i = 0; i < n; ++i)
      noisy[i] = std::min(1.0f, std::max(0.0f, noisy[i] + rng.gauss() * noise_std));
  }
}

} // extern "C"
