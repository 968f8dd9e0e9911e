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
// (1296x840, tile 32, 1.35M pairs) the processed chunks hold 612M in-range
// pair-pixels, of which 200M lie inside their pair's bounding box (11
// operations each: sigma and the cut), 156M within the sigma cut (5 more,
// exp among them) and 156M composite (13 more): 0.075 ms at 67 TFLOP/s.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.67-0.71 ms,
// against 1.37-1.40 ms for the first port's design (every warp evaluating
// every pair on a 32x4 strip, no bounds).
// Design: one block of 256 threads per tile, 4 pixels per thread kept in
// registers, each warp on a 16x8 pixel rectangle.
// - Each chunk's rows are staged with cp.async, double-buffered, and read
//   back as three broadcast 16-byte loads per pair.
// - At staging, one thread per pair computes conservative bounds
//   (composite_common.cuh::pair_bounds): a warp whose rectangle misses the
//   pair's box skips it with a warp-uniform branch, and a pixel whose
//   sigma exceeds the pair's cut skips expf. Both skip only pixels that
//   would not composite, so every pixel that composites runs the same
//   operations in the same order as without the bounds, and the outputs
//   are unchanged.
// - Blocks take tiles longest first (`order`, from the wrapper), so a long
//   tile does not start in the last of the 2.8 waves.
// - __launch_bounds__(256, 3) holds 80 registers for 3 blocks per SM; the
//   few spilled words sit outside the per-pair loop.
#include "composite_common.cuh"

namespace {

using namespace gs;

__global__ void __launch_bounds__(THREADS, 3)
composite_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gid_sorted,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ order,
                     float* __restrict__ out, int ntx, int nty, int tile,
                     int chunk) {
  extern __shared__ float4 smem4[];
  float4* rows = smem4;  // [2][chunk][ROW_F4], double-buffered
  int* gids = reinterpret_cast<int*>(rows + 2 * ROW_F4 * chunk);  // [3][chunk]

  const int t = order[blockIdx.x];
  const int start = tile_starts[t], end = tile_starts[t + 1];
  const int c0 = (start / chunk) * chunk;
  const int nchunks = end > start ? (end - c0 + chunk - 1) / chunk : 0;
  const int pixels = tile * tile;
  const int tloc = t % (ntx * nty);
  const int px0 = (tloc % ntx) * tile, py0 = (tloc / ntx) * tile;
  const int warp = threadIdx.x >> 5;
  const PixelMap pm = pixel_map(tile);
  const float px = (float)(px0 + pm.lx) + 0.5f;

  float py[MAX_PPT], T[MAX_PPT], P[MAX_PPT];
  float cr[MAX_PPT], cg[MAX_PPT], cb[MAX_PPT], cd[MAX_PPT];
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    py[j] = (float)(py0 + pm.ly0 + j * pm.dly) + 0.5f;
    T[j] = 1.f;
    cr[j] = cg[j] = cb[j] = cd[j] = 0.f;
  }

  if (nchunks > 0) {  // block-uniform: ids of chunks 0 and 1, rows of 0
    stage_gids(gid_sorted, c0, start, end, chunk, gids);
    if (nchunks > 1)
      stage_gids(gid_sorted, c0 + chunk, start, end, chunk, gids + chunk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    stage_rows(table, gids, c0, start, end, chunk, rows);
    cp_async_commit();
  }

  int i = 0;
  bool alive = true;  // block-uniform: set by __syncthreads_or
  while (i < nchunks && alive) {
    // Chunk i has landed for every thread, and every thread is done with
    // chunk i - 1, whose buffers now take the rows of chunk i + 1 and the
    // ids of chunk i + 2.
    cp_async_wait_all();
    __syncthreads();
    const float4* cur = rows + (i & 1) * ROW_F4 * chunk;
    if (i + 1 < nchunks)
      stage_rows(table, gids + ((i + 1) % 3) * chunk, c0 + (i + 1) * chunk,
                 start, end, chunk, rows + ((i + 1) & 1) * ROW_F4 * chunk);
    if (i + 2 < nchunks)
      stage_gids(gid_sorted, c0 + (i + 2) * chunk, start, end, chunk,
                 gids + ((i + 2) % 3) * chunk);
    cp_async_commit();
    bound_rows(rows + (i & 1) * ROW_F4 * chunk, chunk, tile, px0, py0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) P[j] = 1.f;
    for (int k = 0; k < chunk; ++k) {
      if (!((pair_mask(cur, k) >> warp) & 1u)) continue;  // warp-uniform
      const float4 a = cur[k * ROW_F4], b = cur[k * ROW_F4 + 1],
                   c = cur[k * ROW_F4 + 2];
      const float mx = a.x, my = a.y, ca = a.z, cbb = a.w;
      const float cc = b.x, opa = b.y, r = b.z, g = b.w;
      const float bl = c.x, d = c.y, s_cut = c.z;
#pragma unroll
      for (int j = 0; j < MAX_PPT; ++j) {
        if (!((pm.has >> j) & 1u)) continue;
        const float dx = __fsub_rn(px, mx), dy = __fsub_rn(py[j], my);
        const float sigma = sigma_at(dx, dy, ca, cbb, cc);
        if (!(sigma <= s_cut)) continue;  // cannot reach alpha >= 1/255
        const float e = expf(-sigma);
        const float araw = __fmul_rn(opa, e);
        if (!(sigma >= 0.f && araw >= ALPHA_MIN)) continue;
        const float alpha = fminf(araw, ALPHA_MAX);
        const float w = alpha * (T[j] * P[j]);
        cr[j] += w * r;
        cg[j] += w * g;
        cb[j] += w * bl;
        cd[j] += w * d;
        P[j] *= 1.f - alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) T[j] *= P[j];
    ++i;
    bool mine = false;
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j)
      mine |= ((pm.has >> j) & 1u) && T[j] > TERM_EPS;
    alive = __syncthreads_or(mine) != 0;
  }
  cp_async_wait_all();  // no copy may land after the block has exited

  float* o = out + (size_t)t * OUT_ROWS * pixels;
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    if (!((pm.has >> j) & 1u)) continue;
    const int p = (pm.ly0 + j * pm.dly) * tile + pm.lx;
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
                             const void* tile_starts, const void* order,
                             void* out, int num_tiles, int ntx, int nty,
                             int tile, int chunk, void* stream) {
  if (num_tiles > 0) {
    const size_t smem =
        sizeof(float4) * 2 * ROW_F4 * chunk + sizeof(int) * 3 * chunk;
    const cudaError_t err = allow_smem<composite_fwd_kernel>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    composite_fwd_kernel<<<num_tiles, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(gid_sorted),
        static_cast<const int*>(tile_starts), static_cast<const int*>(order),
        static_cast<float*>(out), ntx, nty, tile, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
