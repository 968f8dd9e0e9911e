// Shared pieces of the tile compositor kernels (composite_fwd.cu,
// composite_bwd.cu): constants, the block's pixel layout, the conservative
// pair bounds, the chunk staging and sigma, written to match
// gs_init_tpu/ops/rasterize.py::_alpha_terms and its plain PyTorch twin
// (gs_init_tpu_torch/ops/rasterize.py) operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gs {

constexpr int THREADS = 256;      // one block per image tile
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PPT = 4;        // pixels per thread: tile*tile <= 1024
constexpr int OUT_ROWS = 8;       // r, g, b, acc, depth, T_final, nproc, spare
constexpr int ROW_R = 0, ROW_G = 1, ROW_B = 2, ROW_ACC = 3, ROW_DEPTH = 4,
              ROW_T = 5, ROW_NPROC = 6;
constexpr int PACK_COLS = 16;     // table row: mx my ca cb cc opa r g b depth ...
constexpr int NATTR = 10;         // used table columns
constexpr int ROW_F4 = 3;         // a staged pair: table columns 0..11 as 3 float4
constexpr float ALPHA_MAX = 0.999f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float TERM_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ pixel layout

// Tile-local pixel rectangle of warp w (inclusive bounds; empty when
// y0 > y1). Tiles 16 and 32 pack each warp's 32 lanes row-major into a
// rectangle, 16x8 (tile 32) or 8x4 (tile 16), eight of them as 2 columns
// by 4 rows: a smaller perimeter than a strip of whole rows, so fewer
// warps meet a round footprint. Other tiles give lane x column x and warp
// w rows [w R, w R + R), R = ceil(tile / 8).
struct Rect {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ bool packed_tile(int tile) {
  return tile == 16 || tile == 32;
}

__device__ __forceinline__ Rect warp_rect(int w, int tile) {
  if (packed_tile(tile)) {
    const int rw = tile / 2, rh = tile / 4;
    const int x0 = (w & 1) * rw, y0 = (w >> 1) * rh;
    return {x0, x0 + rw - 1, y0, y0 + rh - 1};
  }
  const int rows = (tile + WARPS - 1) / WARPS;
  return {0, min(tile, 32) - 1, w * rows, min(w * rows + rows, tile) - 1};
}

// This thread's pixels: pixel j (j < n, bit j of `has`) sits at tile-local
// column lx, row ly0 + j * dly. All of a thread's pixels share one column,
// so its pixel-centre x is one register.
struct PixelMap {
  int lx, ly0, dly, n;
  unsigned has;
};

__device__ __forceinline__ PixelMap pixel_map(int tile) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rect r = warp_rect(w, tile);
  PixelMap m;
  if (packed_tile(tile)) {
    const int rw = r.x1 - r.x0 + 1, rh = r.y1 - r.y0 + 1;
    m.lx = r.x0 + lane % rw;
    m.ly0 = r.y0 + lane / rw;
    m.dly = 32 / rw;
    m.n = rw * rh / 32;
    m.has = (1u << m.n) - 1u;
  } else {
    m.lx = lane;
    m.ly0 = r.y0;
    m.dly = 1;
    m.n = (tile + WARPS - 1) / WARPS;
    m.has = 0;
    for (int j = 0; j < m.n; ++j)
      if (lane < tile && r.y0 + j <= r.y1) m.has |= 1u << j;
  }
  return m;
}

// ------------------------------------------------------------ pair bounds
//
// For one pair, a cut s_cut on sigma and a bit per warp whose pixel
// rectangle meets the pair's bounding box. Both are conservative: every
// pixel at which the exact test passes (sigma >= 0 and opa e^-sigma >=
// 1/255 in f32) has sigma <= s_cut and lies in the box. So a warp whose bit
// is clear skips the pair, and a pixel whose sigma exceeds s_cut skips
// expf, without changing any decision of the exact test.
//
// Why this is conservative (u = 2^-24, the f32 unit roundoff):
// - opa < 1/255 (f32): the test needs sigma >= 0, so e = expf(-sigma) <= 1
//   and fl(opa e) <= opa < 1/255: never composited. Mask 0, s_cut = -inf.
//   Non-finite inputs: every non-empty warp's bit and s_cut = +inf. ca <= 0,
//   cc <= 0 or D = ca cc - cb^2/4 <= 1e-5 ca cc: every non-empty warp's bit.
// - s_cut. The test needs fl(opa fl(expf(-sigma))) >= fl(1/255). expf is
//   within 2 ulp and each rounding within u, so a pass implies
//   sigma <= ln(255 opa) + 1e-6. s = logf(fl(255 opa)) is within about
//   3u |s| + u of ln(255 opa). s_cut = s + 1e-3 |s| + 1e-3 covers both many
//   times over, and is compared with the same f32 sigma that the test
//   uses, so sigma's own rounding does not enter.
// - Box. sigma = fl(fl(t1 + t2) + t3), t1 = fl(fl(ca dx) dx) and so on,
//   dx = fl(px - mx). With T1, T2, T3 the exact terms at (dx, dy) and Q
//   their sum, |sigma - Q| <= 4.01u (T1 + T2 + |T3|) <= 4.01u (1 + rho)
//   (T1 + T2) and Q >= (1 - rho)(T1 + T2), rho = |cb| / (2 sqrt(ca cc)) < 1.
//   As (1 + rho) / (1 - rho) <= 4 ca cc / D = 4r, |sigma - Q| <= 16.1u r Q
//   = kappa Q with kappa <= 0.096 for r < 1e5. So a pass implies
//   Q <= s_cut / (1 - kappa) <= s_box = s_cut (1 + 4e-6 r). The ellipse
//   Q <= s_box has half-extents sqrt(s_box cc / D) in x and
//   sqrt(s_box ca / D) in y, and |px - mx| <= |dx| (1 + u). Computed in f64
//   (rounding near 1e-16 relative), the half-extents are widened by 1e-5
//   relative and 1e-3 px absolute.
// ops/rasterize.py::pair_bounds mirrors this function; the tests and
// chip_smoke.py check it against the exact test.
//
// Not inlined: its f64 temporaries would otherwise add to the registers
// that the compositing loops hold across it (measured: the kernels then
// spill more and run slower).
struct Bounds {
  float s_cut;
  unsigned mask;
};

__device__ __noinline__ Bounds pair_bounds(float mx, float my, float ca,
                                           float cb, float cc, float opa,
                                           int tile, int px0, int py0) {
  unsigned all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const Rect r = warp_rect(w, tile);
    if (r.y0 <= r.y1) all |= 1u << w;
  }
  if (!(opa >= ALPHA_MIN)) return {-INFINITY, 0u};
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) &&
        isfinite(cc) && isfinite(opa)))
    return {INFINITY, all};
  const float s = logf(255.f * opa);
  const float s_cut = s + 1e-3f * fabsf(s) + 1e-3f;
  const double a = ca, b = cb, c = cc;
  const double D = a * c - 0.25 * b * b;
  if (!(a > 0.0 && c > 0.0 && D > 1e-5 * a * c)) return {s_cut, all};
  const double sb = (double)s_cut * (1.0 + 4e-6 * (a * c / D));
  const double hx = sqrt(sb * c / D) * (1.0 + 1e-5) + 1e-3;
  const double hy = sqrt(sb * a / D) * (1.0 + 1e-5) + 1e-3;
  // Box centre in tile-local pixel units: pixel x has its centre at x + 0.5.
  const double cx = (double)mx - px0 - 0.5, cy = (double)my - py0 - 0.5;
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const Rect r = warp_rect(w, tile);
    if (r.y0 <= r.y1 && cx + hx >= r.x0 && cx - hx <= r.x1 &&
        cy + hy >= r.y0 && cy - hy <= r.y1)
      mask |= 1u << w;
  }
  return {s_cut, mask};
}

// ------------------------------------------------------------ staging
//
// A chunk's pairs are copied with cp.async into shared memory as rows of 3
// float4 (table columns 0..11, the 48 bytes the kernels use of each 64-byte
// row), double-buffered: the copy of chunk i + 1 runs while chunk i
// composites. The pair ids go one chunk further ahead, into a ring of
// three, so a row copy never waits on its id's load.

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of pair ids [base, base + chunk) into gids; ids outside
// [start, end) are not read and land as 0.
__device__ __forceinline__ void stage_gids(const int* __restrict__ gid_sorted,
                                           int base, int start, int end,
                                           int chunk, int* gids) {
  for (int k = threadIdx.x; k < chunk; k += THREADS) {
    const int idx = base + k;
    const bool in = idx >= start && idx < end;
    cp_async4(gids + k, in ? gid_sorted + idx : gid_sorted, in ? 4 : 0);
  }
}

// Issue the copies of the rows of pairs [base, base + chunk), whose ids are
// in gids, all 256 threads taking the 3 * chunk 16-byte pieces. Rows outside
// [start, end) are zero-filled: opacity 0 never composites, as the Pallas
// kernel masks rows outside the tile's range.
__device__ __forceinline__ void stage_rows(const float* __restrict__ table,
                                           const int* gids, int base,
                                           int start, int end, int chunk,
                                           float4* rows) {
  for (int e = threadIdx.x; e < ROW_F4 * chunk; e += THREADS) {
    const int k = e / ROW_F4, part = e - k * ROW_F4;
    const int idx = base + k;
    const bool in = idx >= start && idx < end;
    const float* src =
        in ? table + (size_t)gids[k] * PACK_COLS + part * 4 : table;
    cp_async16(rows + e, src, in ? 16 : 0);
  }
}

// Once a chunk has landed: one thread per pair writes its s_cut and warp
// mask over staged columns 10 and 11, which the kernels do not otherwise
// use. Row k then reads back as three broadcast 16-byte loads:
// (mx, my, ca, cb), (cc, opa, r, g), (b, depth, s_cut, mask).
__device__ __forceinline__ void bound_rows(float4* rows, int chunk, int tile,
                                           int px0, int py0) {
  for (int k = threadIdx.x; k < chunk; k += THREADS) {
    const float4 a = rows[k * ROW_F4], b = rows[k * ROW_F4 + 1];
    const Bounds bd = pair_bounds(a.x, a.y, a.z, a.w, b.x, b.y, tile, px0, py0);
    rows[k * ROW_F4 + 2].z = bd.s_cut;
    rows[k * ROW_F4 + 2].w = __uint_as_float(bd.mask);
  }
}

__device__ __forceinline__ unsigned pair_mask(const float4* rows, int k) {
  return __float_as_uint(rows[k * ROW_F4 + 2].w);
}

// ------------------------------------------------------------ sigma

// sigma = ca dx^2 + cc dy^2 + cb dx dy with the diagonal pre-halved. The
// _rn intrinsics keep nvcc from contracting into FMAs, so sigma and alpha
// round exactly like the elementwise PyTorch ops of the plain version:
// the skip test alpha >= 1/255 and the clamp test then agree pair by pair.
__device__ __forceinline__ float sigma_at(float dx, float dy, float ca,
                                          float cb, float cc) {
  const float t1 = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float t2 = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float t3 = __fmul_rn(__fmul_rn(cb, dx), dy);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device.
// Above 48 KB that needs cudaFuncSetAttribute, set once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  static int allowed[64] = {};  // bytes allowed so far, per device
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) allowed[dev] = static_cast<int>(bytes);
  return err;
}

}  // namespace gs

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
