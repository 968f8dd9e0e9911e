// Tile compositor forward, hand-written for Hopper (sm_90a).
//
// Replaces: gs_init_tpu/ops/rasterize.py::_fwd_kernel (Pallas, host wrapper
// _composite_fwd_call) and the per-pair pack gather before it
// (rasterize.py:1148, jnp.take(table, gid_sorted)).
//
// Computes, for each image tile, front-to-back alpha compositing of the
// tile's depth-sorted pair range [tile_starts[t], tile_starts[t+1]) in
// chunks of `chunk` pairs, the window aligned down to a chunk boundary as
// in the Pallas kernel. Per pair and pixel: sigma, alpha = min(opa e^-sigma,
// 0.999), skipped when sigma < 0 or alpha < 1/255; w = alpha T_k with
// T_k = T_chunk * prod_{j<k in chunk} (1 - alpha_j), the per-chunk prefix
// product the JAX kernel forms, and T_chunk *= that product after the chunk.
// The tile stops only after a WHOLE chunk, once no pixel has T > 1e-4 (the
// JAX termination rule, so outputs match it to float rounding); row 6
// records the chunks processed, which the backward replays.
// Output [num_tiles, 8, tile*tile] f32: r, g, b, acc = 1 - T, depth, T, nproc.
//
// Bound on this card: FP32 arithmetic. At the 300k-gaussian flagship
// (1296x840, tile 32, 1.35M pairs) the processed chunks hold 612M
// pair-pixel evaluations of 16 operations (exp included), 156M of which
// composite (12 more), against ~45 MB of table, index and output traffic:
// 0.17 ms at 67 TFLOP/s, where this kernel took 1.39 ms on an H100 80GB
// HBM3 at 700 W (chip_smoke.py).
// Design: one block of 256 threads per tile, 4 pixels per thread kept in
// registers; each chunk's pair rows are gathered once into shared memory
// (float4 loads of the 64-byte table rows) and read back as broadcasts by
// every thread, so each row is fetched from memory once per tile and the
// inner loop is register arithmetic. Later work: per-pixel exit, cp.async
// double buffering of the next chunk, a cheaper exp.
#include "composite_common.cuh"

namespace {

using namespace gs;

__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gid_sorted,
                     const int* __restrict__ tile_starts,
                     float* __restrict__ out, int ntx, int nty, int tile,
                     int chunk) {
  extern __shared__ float s[];  // [NATTR][chunk]
  const int t = blockIdx.x;
  const int start = tile_starts[t], end = tile_starts[t + 1];
  const int c0 = (start / chunk) * chunk;
  const int nchunks = end > start ? (end - c0 + chunk - 1) / chunk : 0;
  const int pixels = tile * tile;
  const int ppt = (pixels + THREADS - 1) / THREADS;
  const int tloc = t % (ntx * nty);
  const int px0 = (tloc % ntx) * tile, py0 = (tloc / ntx) * tile;

  float px[MAX_PPT], py[MAX_PPT], T[MAX_PPT], P[MAX_PPT];
  float cr[MAX_PPT], cg[MAX_PPT], cb[MAX_PPT], cd[MAX_PPT];
  bool has[MAX_PPT];
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    const int p = pixel_index(j, ppt);
    has[j] = j < ppt && p < pixels;
    px[j] = (float)(px0 + p % tile) + 0.5f;
    py[j] = (float)(py0 + p / tile) + 0.5f;
    T[j] = 1.f;
    cr[j] = cg[j] = cb[j] = cd[j] = 0.f;
  }

  int i = 0;
  bool alive = true;  // block-uniform: set by __syncthreads_or
  while (i < nchunks && alive) {
    __syncthreads();  // every thread is done reading the previous chunk
    load_chunk(table, gid_sorted, c0 + i * chunk, start, end, chunk, s,
               nullptr);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) P[j] = 1.f;
    for (int k = 0; k < chunk; ++k) {
      const float mx = s[0 * chunk + k], my = s[1 * chunk + k];
      const float ca = s[2 * chunk + k], cbb = s[3 * chunk + k];
      const float cc = s[4 * chunk + k], opa = s[5 * chunk + k];
      const float r = s[6 * chunk + k], g = s[7 * chunk + k];
      const float b = s[8 * chunk + k], d = s[9 * chunk + k];
#pragma unroll
      for (int j = 0; j < MAX_PPT; ++j) {
        if (!has[j]) continue;
        const Alpha a = alpha_at(px[j], py[j], mx, my, ca, cbb, cc, opa);
        if (!a.ok) continue;
        const float w = a.alpha * (T[j] * P[j]);
        cr[j] += w * r;
        cg[j] += w * g;
        cb[j] += w * b;
        cd[j] += w * d;
        P[j] *= 1.f - a.alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) T[j] *= P[j];
    ++i;
    bool mine = false;
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) mine |= has[j] && T[j] > TERM_EPS;
    alive = __syncthreads_or(mine) != 0;
  }

  float* o = out + (size_t)t * OUT_ROWS * pixels;
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    if (!has[j]) continue;
    const int p = pixel_index(j, ppt);
    o[ROW_R * pixels + p] = cr[j];
    o[ROW_G * pixels + p] = cg[j];
    o[ROW_B * pixels + p] = cb[j];
    o[ROW_ACC * pixels + p] = 1.f - T[j];
    o[ROW_DEPTH * pixels + p] = cd[j];
    o[ROW_T * pixels + p] = T[j];
    o[ROW_NPROC * pixels + p] = (float)i;
    o[7 * pixels + p] = 0.f;
  }
}

}  // namespace

extern "C" int composite_fwd(const void* table, const void* gid_sorted,
                             const void* tile_starts, void* out,
                             int num_tiles, int ntx, int nty, int tile,
                             int chunk, void* stream) {
  if (num_tiles > 0) {
    const size_t smem = sizeof(float) * NATTR * chunk;
    composite_fwd_kernel<<<num_tiles, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(gid_sorted),
        static_cast<const int*>(tile_starts), static_cast<float*>(out), ntx,
        nty, tile, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
