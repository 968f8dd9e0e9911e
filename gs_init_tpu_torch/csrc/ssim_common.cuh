// Shared by the SSIM kernel pair (K6 ssim_fwd.cu, K7 ssim_bwd.cu): the tile
// geometry, the window, the image strides, the blur and the formula.
//
// Both kernels blur with an 11-tap separable window in the plain twins'
// order (ops/ssim.py): acc = w[0] * x[0], then acc = acc + w[t] * x[t] for
// t = 1..10, each product and sum rounded on its own (the libraries build
// with -fmad=false, kernels.EXTRA_FLAGS), and evaluate the formula and its
// backward operation for operation as the twins do, so the blurred maps and
// the gradient equal the twins' to the bit. Only the mean differs, by its
// order of summation.
#pragma once

#include <cuda_runtime.h>

namespace ssim {

constexpr int K = 11;                // window taps
constexpr int HALO = K - 1;          // the window's reach beyond a tile
constexpr int TILE = 32;             // outputs (K6) or inputs (K7) a block, each way
constexpr int SPAN = TILE + HALO;    // a tile and its halo, each way
constexpr int THREADS = 256;

struct Window {
  float w[K];
};

// Strides of one [B, H, W, C] image in elements: any view, such as
// render[..., :3], is read where it lies.
struct Strides {
  long long b, h, w, c;
};

// 11 blurred taps along a shared-memory column or row: src[0], src[step], ...
__device__ __forceinline__ float blur(const float* src, int step, const Window& win) {
  float acc = win.w[0] * src[0];
#pragma unroll
  for (int t = 1; t < K; ++t) acc = acc + win.w[t] * src[t * step];
  return acc;
}

// The SSIM formula's terms, in ops/ssim.py::_ssim_terms's order; the SSIM
// map is num / den.
struct Terms {
  float a, bn, cc, d, num, den;
};

__device__ __forceinline__ Terms terms(float mu0, float mu1, float e00, float e11, float e01, float c1,
                                       float c2) {
  const float mu00 = mu0 * mu0, mu11 = mu1 * mu1, mu01 = mu0 * mu1;
  const float s00 = e00 - mu00, s11 = e11 - mu11, s01 = e01 - mu01;
  Terms t;
  t.a = 2.0f * mu01 + c1;
  t.bn = 2.0f * s01 + c2;
  t.num = t.a * t.bn;
  t.cc = (mu00 + mu11) + c1;
  t.d = (s00 + s11) + c2;
  t.den = t.cc * t.d;
  return t;
}

}  // namespace ssim

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
