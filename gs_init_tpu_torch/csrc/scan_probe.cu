// Exclusive prefix sum and exclusive prefix product along axis 0,
// hand-written for Hopper (sm_90a).
//
// Replaces: the probe kernel `k` in gs_init_tpu/ops/rasterize.py::_PROBE_SRC
// (driven by _probe_hs_scan, chosen from by _scan_mode), which runs the
// Hillis-Steele in-block scans _hs_scan of two f32 [128, 128] arrays once,
// at the first use of the compositor, and checks them against numpy.
//
// Computes, for x and m of shape [n, p] (row-major, n <= 1024):
//   sum[r, c]  = sum_{j < r} x[j, c]    (0 at r = 0)
//   prod[r, c] = prod_{j < r} m[j, c]   (1 at r = 0)
//
// Bound on this card: memory latency. The probe's 4 arrays of 64 KB are
// 256 KB of traffic and 32k operations; the launch itself dominates.
// Design: one block per column, one thread per row. Each warp scans its 32
// rows with __shfl_up_sync (log2(32) steps, the warp form of the
// Hillis-Steele scan); warp 0 then scans the per-warp totals held in shared
// memory, and each thread combines its warp's prefix with its own inclusive
// value shifted down by one lane to form the exclusive result. Sum and
// product ride the same pass.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROWS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Add {
  static __device__ __forceinline__ float id() { return 0.f; }
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

struct Mul {
  static __device__ __forceinline__ float id() { return 1.f; }
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a * b;
  }
};

// Inclusive scan of v across the 32 lanes of a warp.
template <class Op>
__device__ __forceinline__ float warp_inclusive(float v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = op(u, v);
  }
  return v;
}

// Exclusive scan of v over the block's threads in thread order. `tot` is
// shared scratch of 32 floats; every thread of the block must call this.
template <class Op>
__device__ __forceinline__ float block_exclusive(float v, Op op, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float incl = warp_inclusive(v, op);
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < nwarps ? tot[lane] : Op::id();
    const float wi = warp_inclusive(w, op);
    // Exclusive prefix of the warp totals: warp i starts after warps < i.
    const float we = __shfl_up_sync(FULL, wi, 1);
    tot[lane] = lane == 0 ? Op::id() : we;
  }
  __syncthreads();
  const float prev = __shfl_up_sync(FULL, incl, 1);
  const float r = lane == 0 ? tot[warp] : op(tot[warp], prev);
  __syncthreads();  // tot is reused by the caller's next scan
  return r;
}

__global__ void __launch_bounds__(MAX_ROWS)
scan_probe_kernel(const float* __restrict__ x, const float* __restrict__ m,
                  float* __restrict__ sum, float* __restrict__ prod, int n,
                  int p) {
  __shared__ float tot[32];
  const int c = blockIdx.x, r = threadIdx.x;
  const bool in = r < n;
  const size_t at = (size_t)r * p + c;
  const float xs = in ? x[at] : Add::id();
  const float ms = in ? m[at] : Mul::id();
  const float s = block_exclusive(xs, Add(), tot);
  const float q = block_exclusive(ms, Mul(), tot);
  if (in) {
    sum[at] = s;
    prod[at] = q;
  }
}

}  // namespace

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int scan_probe(const void* x, const void* m, void* sum, void* prod,
                          int n, int p, void* stream) {
  if (n > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && p > 0) {
    const int threads = (n + 31) / 32 * 32;
    scan_probe_kernel<<<p, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(m),
        static_cast<float*>(sum), static_cast<float*>(prod), n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
