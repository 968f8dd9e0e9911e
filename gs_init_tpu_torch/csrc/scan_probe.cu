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
// Bound on this card: the launch. The probe's 4 arrays of 64 KB are 256 KB
// of traffic and 32k operations; a copy of its inputs to its outputs takes
// 1.3 us on the device, which is its bound (the launch and copy floor,
// chip_smoke.py phase 4).
// Design: threads along columns. A block takes COLS consecutive columns
// and SEGS segments of rows: thread (c, g) walks the rows of segment g of
// its column, so a warp's load or store touches COLS consecutive floats of
// each of 32 / COLS rows, whole 32-byte sectors (the first design put one
// column per block and one row per thread, each warp reading 32 rows with
// a stride of p floats, and sat at half of the floor). A first pass
// reduces each segment, sum and product together; the SEGS totals of a
// column meet in shared memory; each thread then starts from the totals
// of the segments above its own and writes the exclusive scan of its
// rows, re-reading them from L1. The work is a chain of dependent adds
// and multiplies, so short segments win: at [128, 128], 32 segments of 4
// rows in 16 blocks of 8 columns.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROWS = 1024;
constexpr int COLS = 8;
constexpr int SEGS = 32;

__global__ void __launch_bounds__(COLS * SEGS)
scan_probe_kernel(const float* __restrict__ x, const float* __restrict__ m,
                  float* __restrict__ sum, float* __restrict__ prod, int n,
                  int p) {
  __shared__ float tot_s[SEGS][COLS];
  __shared__ float tot_p[SEGS][COLS];
  const int cx = threadIdx.x, g = threadIdx.y;
  const int c = blockIdx.x * COLS + cx;
  const int len = (n + SEGS - 1) / SEGS;
  const int r0 = min(n, g * len), r1 = min(n, r0 + len);
  const bool col = c < p;
  float s = 0.f, q = 1.f;
  if (col) {
    for (int r = r0; r < r1; ++r) {
      const size_t at = (size_t)r * p + c;
      s += x[at];
      q *= m[at];
    }
  }
  tot_s[g][cx] = s;
  tot_p[g][cx] = q;
  __syncthreads();
  s = 0.f;
  q = 1.f;
  for (int h = 0; h < g; ++h) {
    s += tot_s[h][cx];
    q *= tot_p[h][cx];
  }
  if (col) {
    for (int r = r0; r < r1; ++r) {
      const size_t at = (size_t)r * p + c;
      sum[at] = s;
      prod[at] = q;
      s += x[at];
      q *= m[at];
    }
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
    scan_probe_kernel<<<(p + COLS - 1) / COLS, dim3(COLS, SEGS), 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(m),
        static_cast<float*>(sum), static_cast<float*>(prod), n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
