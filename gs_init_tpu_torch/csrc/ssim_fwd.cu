// SSIM forward (K6), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's SSIM (gs_init_tpu/ops/ssim.py) is
// plain XLA, which fuses the blur into the step's program. The port ran it as
// torch ops, 11 + 11 shifted slices each way over 15 planes of the image:
// ~55 elementwise launches forward and ~75 through autograd backward, each a
// full pass through device memory, the train step's largest device cost. This
// kernel and K7 (ssim_bwd.cu) compute the same SSIM and gradient in one pass
// each.
//
// Computes, for images img0, img1 [B, H, W, C] (any strides) and each output
// pixel q of the valid region [H - 10, W - 10] of each image and channel, as
// ops/ssim.py::ssim_fwd_plain does:
// - the blurred maps mu0, mu1, E[x0^2], E[x1^2], E[x0 x1] (ssim_common.cuh),
//   written where a gradient is wanted (maps non-null) as [B, 5, C, Ho, Wo]
//   for K7, which computes the formula's backward from them;
// - the SSIM map (2 mu0 mu1 + c1) (2 sigma01 + c2) / ((mu0^2 + mu1^2 + c1)
//   (sigma00 + sigma11 + c2)) (ssim_common.cuh terms);
// - one sum of it a block (in double, in a fixed order), and a second kernel
//   that sums those in a fixed order into the mean: no atomics, so the value
//   is the same to the bit from run to run.
//
// Bound on this card: bytes. It reads both images once (2 x 13.1 MB at
// 1296x840x3) and writes the five maps (5 x 12.8 MB): 90 MB, 0.027 ms at
// 3.35 TB/s; without the maps (eval) 26 MB, where its ~250 FP32 operations a
// pixel (0.012 ms at 67 TFLOP/s) bound it. Design: one block per 32x32
// output tile of one image and channel; the tile and its 10-pixel halo of
// both images go to shared memory, the vertical pass of the five maps to
// shared memory, the horizontal pass and the formula to registers. The maps
// are written a warp per row.
#include "ssim_common.cuh"

namespace {

using namespace ssim;

struct FwdArgs {
  const float* x0;
  const float* x1;
  Strides s0, s1;
  Window win;
  float* maps;   // [B, 5, C, Ho, Wo] or null (no gradient wanted)
  double* sums;  // one a block
  int h, w, c, ho, wo;
  float c1, c2;
};

__global__ void __launch_bounds__(THREADS) ssim_fwd_kernel(const FwdArgs p) {
  __shared__ float raw0[SPAN * SPAN];
  __shared__ float raw1[SPAN * SPAN];
  __shared__ float vert[5][TILE * SPAN];
  __shared__ double warp_sums[THREADS / 32];

  const int plane = blockIdx.z;  // b * C + channel
  const int b = plane / p.c, ch = plane % p.c;
  const int oy = blockIdx.y * TILE, ox = blockIdx.x * TILE;
  const float* x0 = p.x0 + b * p.s0.b + ch * p.s0.c;
  const float* x1 = p.x1 + b * p.s1.b + ch * p.s1.c;

  // The tile and its halo; beyond the image (read only by outputs beyond the
  // valid region, which are not kept) zeros.
  for (int i = threadIdx.x; i < SPAN * SPAN; i += THREADS) {
    const int y = oy + i / SPAN, x = ox + i % SPAN;
    float v0 = 0.0f, v1 = 0.0f;
    if (y < p.h && x < p.w) {
      v0 = x0[y * p.s0.h + x * p.s0.w];
      v1 = x1[y * p.s1.h + x * p.s1.w];
    }
    raw0[i] = v0;
    raw1[i] = v1;
  }
  __syncthreads();

  // Vertical pass over TILE rows and SPAN columns; the products x0 x0, x1 x1
  // and x0 x1 rounded before they are weighted, as the plain twin's planes.
  for (int i = threadIdx.x; i < TILE * SPAN; i += THREADS) {
    float a = raw0[i], e = raw1[i];
    float w = p.win.w[0];
    float m0 = w * a, m1 = w * e, q00 = w * (a * a), q11 = w * (e * e), q01 = w * (a * e);
#pragma unroll
    for (int t = 1; t < K; ++t) {
      a = raw0[i + t * SPAN];
      e = raw1[i + t * SPAN];
      w = p.win.w[t];
      m0 = m0 + w * a;
      m1 = m1 + w * e;
      q00 = q00 + w * (a * a);
      q11 = q11 + w * (e * e);
      q01 = q01 + w * (a * e);
    }
    vert[0][i] = m0;
    vert[1][i] = m1;
    vert[2][i] = q00;
    vert[3][i] = q11;
    vert[4][i] = q01;
  }
  __syncthreads();

  // Horizontal pass and the formula, a warp per output row.
  double acc = 0.0;
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, col = i % TILE;
    const int y = oy + r, x = ox + col;
    if (y >= p.ho || x >= p.wo) continue;
    const int at = r * SPAN + col;
    const float mu0 = blur(&vert[0][at], 1, p.win);
    const float mu1 = blur(&vert[1][at], 1, p.win);
    const float e00 = blur(&vert[2][at], 1, p.win);
    const float e11 = blur(&vert[3][at], 1, p.win);
    const float e01 = blur(&vert[4][at], 1, p.win);
    const Terms t = terms(mu0, mu1, e00, e11, e01, p.c1, p.c2);
    acc += static_cast<double>(t.num / t.den);
    if (p.maps != nullptr) {
      const long long plane_size = static_cast<long long>(p.ho) * p.wo;
      float* o = p.maps + (static_cast<long long>(b) * 5 * p.c + ch) * plane_size + y * p.wo + x;
      const long long step = p.c * plane_size;  // from one map to the next
      o[0] = mu0;
      o[step] = mu1;
      o[2 * step] = e00;
      o[3 * step] = e11;
      o[4 * step] = e01;
    }
  }

  // The block's sum: each warp's lanes in a fixed tree, then the warps in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) s += warp_sums[k];
    p.sums[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

constexpr int FINISH_THREADS = 1024;

// The blocks' sums in a fixed order (a strided sum a thread, then a tree),
// over the count, into the mean.
__global__ void __launch_bounds__(FINISH_THREADS)
ssim_finish_kernel(const double* sums, int n, double count, float* out) {
  __shared__ double part[FINISH_THREADS];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) s += sums[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = FINISH_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(part[0] / count);
}

}  // namespace

// strides: host [8] (img0's b, h, w, c, then img1's); window: host [11].
// nsums must be the grid's block count, ceil(Wo / 32) * ceil(Ho / 32) * B * C.
extern "C" int ssim_fwd(const void* x0, const void* x1, const void* strides, const void* window, void* maps,
                        void* sums, void* out, int nsums, int b, int h, int w, int c, float c1, float c2,
                        void* stream) {
  const int ho = h - HALO, wo = w - HALO;
  if (b <= 0 || c <= 0 || ho <= 0 || wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((wo + TILE - 1) / TILE, (ho + TILE - 1) / TILE, b * c);
  if (static_cast<long long>(grid.x) * grid.y * grid.z != nsums || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs p;
  const long long* st = static_cast<const long long*>(strides);
  p.x0 = static_cast<const float*>(x0);
  p.x1 = static_cast<const float*>(x1);
  p.s0 = Strides{st[0], st[1], st[2], st[3]};
  p.s1 = Strides{st[4], st[5], st[6], st[7]};
  for (int t = 0; t < K; ++t) p.win.w[t] = static_cast<const float*>(window)[t];
  p.maps = static_cast<float*>(maps);
  p.sums = static_cast<double*>(sums);
  p.h = h;
  p.w = w;
  p.c = c;
  p.ho = ho;
  p.wo = wo;
  p.c1 = c1;
  p.c2 = c2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssim_fwd_kernel<<<grid, THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const double count = static_cast<double>(b) * c * ho * wo;
  ssim_finish_kernel<<<1, FINISH_THREADS, 0, s>>>(static_cast<const double*>(sums), nsums, count,
                                                  static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
