// Shared pieces of the tile compositor kernels (composite_fwd.cu,
// composite_bwd.cu): constants, the block's pixel layout, the chunk load
// and the per-pair-pixel alpha, written to match
// gs_init_tpu/ops/rasterize.py::_alpha_terms and its plain PyTorch twin
// (gs_init_tpu_torch/ops/rasterize.py) operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int THREADS = 256;      // one block per image tile
constexpr int MAX_PPT = 4;        // pixels per thread: tile*tile <= 1024
constexpr int OUT_ROWS = 8;       // r, g, b, acc, depth, T_final, nproc, spare
constexpr int ROW_R = 0, ROW_G = 1, ROW_B = 2, ROW_ACC = 3, ROW_DEPTH = 4,
              ROW_T = 5, ROW_NPROC = 6;
constexpr int PACK_COLS = 16;     // table row: mx my ca cb cc opa r g b depth ...
constexpr int NATTR = 10;         // used table columns
constexpr float ALPHA_MAX = 0.999f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float TERM_EPS = 1e-4f;

// Pixel j of this thread (j < MAX_PPT). A warp covers PPT consecutive rows
// of 32 pixels (tile 32) so its pixels are spatially compact; p >= pixels
// means no pixel (tile 8 leaves warps 2..7 idle).
__device__ __forceinline__ int pixel_index(int j, int ppt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp * ppt + j) * 32 + lane;
}

// Stage pair rows [base, base + chunk) of this tile into shared memory as
// structure of arrays s[col * chunk + k]. Rows outside [start, end) get
// zeros: opacity 0 gives alpha 0 < ALPHA_MIN, i.e. the pair is skipped,
// exactly as the Pallas kernel masks rows outside the tile's range.
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ table, const int* __restrict__ gid_sorted,
    int base, int start, int end, int chunk, float* s, int* s_gid) {
  for (int k = threadIdx.x; k < chunk; k += THREADS) {
    const int idx = base + k;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, c = a;
    int g = -1;
    if (idx >= start && idx < end) {
      g = gid_sorted[idx];
      const float4* row =
          reinterpret_cast<const float4*>(table + (size_t)g * PACK_COLS);
      a = row[0];
      b = row[1];
      c = row[2];
    }
    s[0 * chunk + k] = a.x;  // mx
    s[1 * chunk + k] = a.y;  // my
    s[2 * chunk + k] = a.z;  // 0.5 * conic a
    s[3 * chunk + k] = a.w;  // conic b
    s[4 * chunk + k] = b.x;  // 0.5 * conic c
    s[5 * chunk + k] = b.y;  // opacity
    s[6 * chunk + k] = b.z;  // r
    s[7 * chunk + k] = b.w;  // g
    s[8 * chunk + k] = c.x;  // b
    s[9 * chunk + k] = c.y;  // depth
    if (s_gid) s_gid[k] = g;
  }
}

struct Alpha {
  float dx, dy, e, araw, alpha;
  bool ok;
};

// sigma = ca dx^2 + cc dy^2 + cb dx dy with the diagonal pre-halved. The
// _rn intrinsics keep nvcc from contracting into FMAs, so sigma and alpha
// round exactly like the elementwise PyTorch ops of the plain version:
// the skip test alpha >= 1/255 and the clamp test then agree pair by pair.
__device__ __forceinline__ Alpha alpha_at(float px, float py, float mx,
                                          float my, float ca, float cb,
                                          float cc, float opa) {
  Alpha r;
  r.dx = __fsub_rn(px, mx);
  r.dy = __fsub_rn(py, my);
  const float t1 = __fmul_rn(__fmul_rn(ca, r.dx), r.dx);
  const float t2 = __fmul_rn(__fmul_rn(cc, r.dy), r.dy);
  const float t3 = __fmul_rn(__fmul_rn(cb, r.dx), r.dy);
  const float sigma = __fadd_rn(__fadd_rn(t1, t2), t3);
  r.e = expf(-sigma);
  r.araw = __fmul_rn(opa, r.e);
  r.ok = (sigma >= 0.f) && (r.araw >= ALPHA_MIN);
  r.alpha = r.ok ? fminf(r.araw, ALPHA_MAX) : 0.f;
  return r;
}

}  // namespace gs

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
