// Tile compositor backward, hand-written for Hopper (sm_90a).
//
// Replaces: gs_init_tpu/ops/rasterize.py::_bwd_kernel (Pallas, host wrapper
// _composite_bwd_call) together with its XLA half, the gradient-record sort
// and presort segment reduction (rasterize.py::reduce_records,
// tiles.py::segment_reduce_presort): per-pair gradients are reduced inside
// the block and added straight into the per-gaussian rows with atomics.
//
// Computes, per tile, a front-to-back replay of exactly the chunks the
// forward processed (row 6 of its output), rebuilding T by the forward's
// own recurrence. The suffix sum each pair needs comes from the forward
// totals: S = r_tot - gt - sum_{j<=k} u_j, with r_tot = sum_ch g_ch out_ch,
// gt = (g_acc - g_T) T_final and u_j = q_j w_j, carried with a compensated
// (Kahan) update because S is a small difference of large sums deep in an
// opaque stack. dalpha = q T_k - S / (1 - alpha), then
//   live pairs (alpha not clamped): d opacity, d(0.5a, b, 0.5c), d mean2d;
//   every composited pair: d rgb and d depth through w.
// No log-space or back-to-front T recovery (T_k = T_{k+1} / (1 - alpha)):
// T_final can underflow in deep stacks under chunk-granular termination.
// Outputs (zeroed by the caller): dtable [C*N, 16] (columns 0..9) and, when
// requested, absgrad [C*N, 2] += |sum over the tile's pixels of d mean2d|,
// the absolute value taken per (pair, tile) as the JAX records do.
//
// Bound on this card: FP32 arithmetic. At the 300k-gaussian flagship the
// replay re-evaluates the 200M pair-pixels inside their pairs' boxes (11
// operations), 5 more for the 156M within the sigma cut, and 42 more for
// each of the 156M that composite, a divide among them: 0.142 ms at 67
// TFLOP/s. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py):
// 1.41-1.42 ms, against 3.42-3.46 ms for the first port's design (shared
// atomics after a 50-shuffle reduction per pair, no bounds).
// Design: the forward's block layout, staging, pair bounds and tile order
// (the same `order` array: it measured 3% faster here than an order by
// chunks processed), plus:
// - A warp whose bit is clear skips the pair, its reduction included.
// - A warp that evaluated pair k sums its lanes' ten gradient terms by
//   recursive halving (12 shuffles) and stores them into its own slot
//   part[warp][k] with plain stores, zeros if no lane composited. After
//   the chunk, one thread per pair adds the slots of the warps in its mask
//   in a fixed order (deterministic within the block), then adds each
//   non-zero value of the block total to dtable and absgrad with a scalar
//   atomic (float4/float2 atomics measured no faster).
// - __launch_bounds__(256, 3) holds 80 registers, without spills, for 3
//   blocks per SM (53.5 KB of shared memory each at chunk 128).
#include "composite_common.cuh"

namespace {

using namespace gs;

constexpr int NACC = 10;  // sx sy dca dcb dcc dopa dr dg db dd

// Sum v[0..9] over the warp by recursive halving: at each xor step a lane
// keeps half of its remaining values and sends the other half, so the ten
// sums take 5 + 3 + 2 + 1 + 1 = 12 shuffles (a tree per value takes 50).
// Lane L ends with the warp total of value reduced_index(L), as does
// L ^ 1, where reduced_valid(L); other lanes hold zeros.
__device__ __forceinline__ float warp_sum10(const float (&v)[NACC], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {  // b4 keeps values 5..9, else 0..4
    const float keep = b4 ? v[5 + i] : v[i], send = b4 ? v[i] : v[5 + i];
    a[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {  // b3 keeps a3 a4 and a zero, else a0 a1 a2
    const float hi = i < 2 ? a[3 + i] : 0.f;
    const float keep = b3 ? hi : a[i], send = b3 ? a[i] : hi;
    c[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  // b2 keeps c2 and a zero, else c0 c1
  const float e0 = (b2 ? c[2] : c[0]) + __shfl_xor_sync(FULL, b2 ? c[0] : c[2], 4);
  const float e1 = (b2 ? 0.f : c[1]) + __shfl_xor_sync(FULL, b2 ? c[1] : 0.f, 4);
  const float f = (b1 ? e1 : e0) + __shfl_xor_sync(FULL, b1 ? e0 : e1, 2);
  return f + __shfl_xor_sync(FULL, f, 1);
}

__device__ __forceinline__ int reduced_index(int lane) {
  return 5 * ((lane >> 4) & 1) + 3 * ((lane >> 3) & 1) + 2 * ((lane >> 2) & 1) +
         ((lane >> 1) & 1);
}

__device__ __forceinline__ bool reduced_valid(int lane) {
  return !((lane & 4) && (lane & 10));
}

__global__ void __launch_bounds__(THREADS, 3)
composite_bwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gid_sorted,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ order,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ g_out,
                     float* __restrict__ dtable, float* __restrict__ absgrad,
                     int ntx, int nty, int tile, int chunk,
                     int want_absgrad) {
  extern __shared__ float4 smem4[];
  float4* rows = smem4;  // [2][chunk][ROW_F4], double-buffered
  int* gids = reinterpret_cast<int*>(rows + 2 * ROW_F4 * chunk);  // [3][chunk]
  float* part = reinterpret_cast<float*>(gids + 3 * chunk);  // [WARPS][chunk][NACC]

  const int t = order[blockIdx.x];
  const int start = tile_starts[t], end = tile_starts[t + 1];
  const int c0 = (start / chunk) * chunk;
  const int pixels = tile * tile;
  const float* fo = fwd_out + (size_t)t * OUT_ROWS * pixels;
  const float* go = g_out + (size_t)t * OUT_ROWS * pixels;
  const int nproc = (int)fo[ROW_NPROC * pixels];  // same for every pixel
  if (end <= start || nproc == 0) return;  // block-uniform
  const int tloc = t % (ntx * nty);
  const int px0 = (tloc % ntx) * tile, py0 = (tloc / ntx) * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const PixelMap pm = pixel_map(tile);
  const float px = (float)(px0 + pm.lx) + 0.5f;

  float py[MAX_PPT], T[MAX_PPT], P[MAX_PPT], S[MAX_PPT], comp[MAX_PPT];
  float gr[MAX_PPT], gg[MAX_PPT], gb[MAX_PPT], gd[MAX_PPT];
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    py[j] = (float)(py0 + pm.ly0 + j * pm.dly) + 0.5f;
    T[j] = 1.f;
    comp[j] = 0.f;
    gr[j] = gg[j] = gb[j] = gd[j] = S[j] = 0.f;
    if (!((pm.has >> j) & 1u)) continue;
    const int p = (pm.ly0 + j * pm.dly) * tile + pm.lx;
    gr[j] = go[ROW_R * pixels + p];
    gg[j] = go[ROW_G * pixels + p];
    gb[j] = go[ROW_B * pixels + p];
    gd[j] = go[ROW_DEPTH * pixels + p];
    const float g_tn = go[ROW_ACC * pixels + p] - go[ROW_T * pixels + p];
    const float gt = g_tn * fo[ROW_T * pixels + p];
    const float r_tot = gr[j] * fo[ROW_R * pixels + p] +
                        gg[j] * fo[ROW_G * pixels + p] +
                        gb[j] * fo[ROW_B * pixels + p] +
                        gd[j] * fo[ROW_DEPTH * pixels + p];
    S[j] = r_tot - gt;
  }

  // Ids of chunks 0 and 1, rows of chunk 0.
  stage_gids(gid_sorted, c0, start, end, chunk, gids);
  if (nproc > 1)
    stage_gids(gid_sorted, c0 + chunk, start, end, chunk, gids + chunk);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  stage_rows(table, gids, c0, start, end, chunk, rows);
  cp_async_commit();

  for (int i = 0; i < nproc; ++i) {
    const int base = c0 + i * chunk;
    // Chunk i has landed for every thread, and every thread is done with
    // chunk i - 1 (its epilogue included), whose buffers now take the rows
    // of chunk i + 1 and the ids of chunk i + 2.
    cp_async_wait_all();
    __syncthreads();
    const float4* cur = rows + (i & 1) * ROW_F4 * chunk;
    const int* cur_gid = gids + (i % 3) * chunk;
    if (i + 1 < nproc)
      stage_rows(table, gids + ((i + 1) % 3) * chunk, base + chunk, start,
                 end, chunk, rows + ((i + 1) & 1) * ROW_F4 * chunk);
    if (i + 2 < nproc)
      stage_gids(gid_sorted, base + 2 * chunk, start, end, chunk,
                 gids + ((i + 2) % 3) * chunk);
    cp_async_commit();
    bound_rows(rows + (i & 1) * ROW_F4 * chunk, chunk, tile, px0, py0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) P[j] = 1.f;
    for (int k = 0; k < chunk; ++k) {
      if (!((pair_mask(cur, k) >> warp) & 1u)) continue;  // warp-uniform
      const float4 a4 = cur[k * ROW_F4], b4 = cur[k * ROW_F4 + 1],
                   c4 = cur[k * ROW_F4 + 2];
      const float mx = a4.x, my = a4.y, ca = a4.z, cbb = a4.w;
      const float cc = b4.x, opa = b4.y, r = b4.z, g = b4.w;
      const float b = c4.x, d = c4.y, s_cut = c4.z;
      float v[NACC];
#pragma unroll
      for (int c = 0; c < NACC; ++c) v[c] = 0.f;
      bool any = false;
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
        any = true;
        const float om = 1.f - alpha;
        const float inv1m = 1.f / om;
        const float tk = T[j] * P[j];
        const float w = alpha * tk;
        const float q = r * gr[j] + g * gg[j] + b * gb[j] + d * gd[j];
        const float u = q * w;
        // Kahan: S -= u, so S = r_tot - gt - sum_{j<=k} u_j = r_in[k].
        const float y = -u - comp[j];
        const float tsum = S[j] + y;
        comp[j] = (tsum - S[j]) - y;
        S[j] = tsum;
        const float dalpha = q * tk - S[j] * inv1m;
        v[6] += w * gr[j];
        v[7] += w * gg[j];
        v[8] += w * gb[j];
        v[9] += w * gd[j];
        if (araw <= ALPHA_MAX) {  // unclamped: alpha = opa * e
          const float de = dalpha * e;
          const float dsig = de * (-opa);
          const float dsx = dsig * dx, dsy = dsig * dy;
          v[0] += dsx;
          v[1] += dsy;
          v[2] += dsx * dx;
          v[3] += dsx * dy;
          v[4] += dsy * dy;
          v[5] += de;
        }
        P[j] *= om;
      }
      // Every warp whose bit is set fills its slot, so the block sum below
      // reads exactly those slots.
      float* slot = part + ((size_t)warp * chunk + k) * NACC;
      if (__any_sync(FULL, any)) {  // warp-uniform
        const float f = warp_sum10(v, lane);
        if (!(lane & 1) && reduced_valid(lane)) slot[reduced_index(lane)] = f;
      } else if (!(lane & 1) && reduced_valid(lane)) {
        slot[reduced_index(lane)] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) T[j] *= P[j];
    __syncthreads();
    for (int k = threadIdx.x; k < chunk; k += THREADS) {
      const int idx = base + k;
      if (idx < start || idx >= end) continue;  // row outside the tile's range
      const unsigned mask = pair_mask(cur, k);
      if (!mask) continue;  // no warp evaluated the pair: zero gradient
      float sum[NACC];
#pragma unroll
      for (int c = 0; c < NACC; ++c) sum[c] = 0.f;
      for (int w = 0; w < WARPS; ++w) {  // fixed order: deterministic
        if (!((mask >> w) & 1u)) continue;
        const float* slot = part + ((size_t)w * chunk + k) * NACC;
#pragma unroll
        for (int c = 0; c < NACC; ++c) sum[c] += slot[c];
      }
      const float ca = cur[k * ROW_F4].z, cbb = cur[k * ROW_F4].w;
      const float cc = cur[k * ROW_F4 + 1].x;
      const float sx = sum[0], sy = sum[1];
      const float dmx = -(2.f * ca * sx + cbb * sy);
      const float dmy = -(2.f * cc * sy + cbb * sx);
      const int gid = cur_gid[k];
      float* row = dtable + (size_t)gid * PACK_COLS;
      sum[0] = dmx;
      sum[1] = dmy;
#pragma unroll
      for (int c = 0; c < NACC; ++c)
        if (sum[c] != 0.f) atomicAdd(&row[c], sum[c]);
      if (want_absgrad) {
        if (dmx != 0.f) atomicAdd(&absgrad[(size_t)gid * 2 + 0], fabsf(dmx));
        if (dmy != 0.f) atomicAdd(&absgrad[(size_t)gid * 2 + 1], fabsf(dmy));
      }
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const void* table, const void* gid_sorted,
                             const void* tile_starts, const void* order,
                             const void* fwd_out, const void* g_out,
                             void* dtable, void* absgrad, int num_tiles,
                             int ntx, int nty, int tile, int chunk,
                             int want_absgrad, void* stream) {
  if (num_tiles > 0) {
    const size_t smem = sizeof(float4) * 2 * ROW_F4 * chunk +
                        sizeof(int) * 3 * chunk +
                        sizeof(float) * WARPS * NACC * chunk;
    const cudaError_t err = allow_smem<composite_bwd_kernel>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    composite_bwd_kernel<<<num_tiles, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(gid_sorted),
        static_cast<const int*>(tile_starts), static_cast<const int*>(order),
        static_cast<const float*>(fwd_out), static_cast<const float*>(g_out),
        static_cast<float*>(dtable), static_cast<float*>(absgrad), ntx, nty,
        tile, chunk, want_absgrad);
  }
  return static_cast<int>(cudaGetLastError());
}
