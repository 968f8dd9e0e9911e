// SSIM backward (K7), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the VJP of the JAX package's SSIM
// (gs_init_tpu/ops/ssim.py), which XLA fused; the port ran it through
// autograd as ~75 elementwise launches (ssim_fwd.cu says why both were
// added). It computes ops/ssim.py::ssim_bwd_plain, which is autograd's
// backward through the plain ops, operation for operation.
//
// Computes, for each input pixel p of img0 [B, H, W, C] and each channel, the
// gradient of grad * mean(SSIM map) from K6's five blurred maps:
// - at each valid output q, g = grad * (1 / count) (the mean's backward), and
//   the formula's backward in autograd's order: the partial maps P_mu0
//   (through the sigma terms too), P_e00 and P_e01, zero outside the valid
//   region;
// - G = the transposed blur of P: p gathers the outputs q in [p - 10, p] each
//   way, the horizontal pass first (the plain twin's blur over P padded by 10
//   zeros, with the window reversed, which the wrapper passes);
// - dL/dx0 = ((G_mu0 + G_e01 x1) + G_e00 x0) + G_e00 x0, written contiguous
//   [B, H, W, C].
// grad is read on the card (a 0-dim tensor), never on the host. img1, the
// target, takes no gradient.
//
// Bound on this card: bytes. It reads the five maps (5 x 12.8 MB) and both
// images (2 x 13.1 MB) and writes one gradient (13.1 MB): 103 MB, 0.031 ms
// at 3.35 TB/s; ~500 FP32 operations a pixel, 0.024 ms at 67 TFLOP/s.
// Design: one block per 32x32 input tile of one image and channel; the
// partial maps over the tile and its 10-pixel halo to shared memory, the
// horizontal pass to shared memory, the vertical pass and the combination
// in registers.
#include "ssim_common.cuh"

namespace {

using namespace ssim;

struct BwdArgs {
  const float* x0;
  const float* x1;
  Strides s0, s1;
  Window win;         // reversed
  const float* maps;  // [B, 5, C, Ho, Wo]
  const float* grad;  // [1]
  float inv_count;
  float* dx;  // [B, H, W, C] contiguous
  int h, w, c, ho, wo;
  float c1, c2;
};

__global__ void __launch_bounds__(THREADS) ssim_bwd_kernel(const BwdArgs p) {
  __shared__ float part[3][SPAN * SPAN];
  __shared__ float horiz[3][SPAN * TILE];

  const int plane = blockIdx.z;
  const int b = plane / p.c, ch = plane % p.c;
  const int iy = blockIdx.y * TILE, ix = blockIdx.x * TILE;
  const float g = p.grad[0] * p.inv_count;

  // The partial maps over rows [iy - 10, iy + 32) and columns [ix - 10,
  // ix + 32), zero outside the valid region.
  const long long plane_size = static_cast<long long>(p.ho) * p.wo;
  const float* maps = p.maps + (static_cast<long long>(b) * 5 * p.c + ch) * plane_size;
  const long long step = p.c * plane_size;  // from one map to the next
  for (int i = threadIdx.x; i < SPAN * SPAN; i += THREADS) {
    const int y = iy - HALO + i / SPAN, x = ix - HALO + i % SPAN;
    float p_mu = 0.0f, p_e00 = 0.0f, p_e01 = 0.0f;
    if (y >= 0 && y < p.ho && x >= 0 && x < p.wo) {
      const float* m = maps + static_cast<long long>(y) * p.wo + x;
      const float mu0 = m[0], mu1 = m[step];
      const Terms t = terms(mu0, mu1, m[2 * step], m[3 * step], m[4 * step], p.c1, p.c2);
      const float g_num = g / t.den;
      const float g_den = (-g) * ((t.num / t.den) / t.den);
      p_e01 = (g_num * t.a) * 2.0f;
      p_e00 = g_den * t.cc;
      const float t01 = ((g_num * t.bn) * 2.0f - p_e01) * mu1;
      const float t00 = (g_den * t.d - p_e00) * mu0;
      p_mu = (t01 + t00) + t00;
    }
    part[0][i] = p_mu;
    part[1][i] = p_e00;
    part[2][i] = p_e01;
  }
  __syncthreads();

  // Horizontal pass over SPAN rows and TILE columns, a warp per row.
  for (int i = threadIdx.x; i < SPAN * TILE; i += THREADS) {
    const int at = (i / TILE) * SPAN + i % TILE;
#pragma unroll
    for (int k = 0; k < 3; ++k) horiz[k][i] = blur(&part[k][at], 1, p.win);
  }
  __syncthreads();

  const float* x0 = p.x0 + b * p.s0.b + ch * p.s0.c;
  const float* x1 = p.x1 + b * p.s1.b + ch * p.s1.c;
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int y = iy + i / TILE, x = ix + i % TILE;
    if (y >= p.h || x >= p.w) continue;
    const float g_mu = blur(&horiz[0][i], TILE, p.win);
    const float g_e00 = blur(&horiz[1][i], TILE, p.win);
    const float g_e01 = blur(&horiz[2][i], TILE, p.win);
    const float a = x0[y * p.s0.h + x * p.s0.w];
    const float e = x1[y * p.s1.h + x * p.s1.w];
    p.dx[((static_cast<long long>(b) * p.h + y) * p.w + x) * p.c + ch] =
        ((g_mu + g_e01 * e) + g_e00 * a) + g_e00 * a;
  }
}

}  // namespace

// strides: host [8] (img0's b, h, w, c, then img1's); window: host [11], reversed.
extern "C" int ssim_bwd(const void* x0, const void* x1, const void* strides, const void* window, const void* maps,
                        const void* grad, void* dx, int b, int h, int w, int c, float inv_count, float c1,
                        float c2, void* stream) {
  const int ho = h - HALO, wo = w - HALO;
  if (b <= 0 || c <= 0 || ho <= 0 || wo <= 0 || b * c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs p;
  const long long* st = static_cast<const long long*>(strides);
  p.x0 = static_cast<const float*>(x0);
  p.x1 = static_cast<const float*>(x1);
  p.s0 = Strides{st[0], st[1], st[2], st[3]};
  p.s1 = Strides{st[4], st[5], st[6], st[7]};
  for (int t = 0; t < K; ++t) p.win.w[t] = static_cast<const float*>(window)[t];
  p.maps = static_cast<const float*>(maps);
  p.grad = static_cast<const float*>(grad);
  p.inv_count = inv_count;
  p.dx = static_cast<float*>(dx);
  p.h = h;
  p.w = w;
  p.c = c;
  p.ho = ho;
  p.wo = wo;
  p.c1 = c1;
  p.c2 = c2;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, b * c);
  ssim_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
