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
// replay re-evaluates the forward's 612M pair-pixels (16 operations) and
// runs ~40 more, a divide among them, for each of the 156M that composite,
// against ~110 MB of traffic: 0.24 ms at 67 TFLOP/s, where this kernel
// took 3.46 ms on an H100 80GB HBM3 at 700 W (chip_smoke.py).
// Design: the forward's block layout (256 threads, 4 pixels each). Per
// pair, each thread sums its pixels' ten gradient terms in registers; a
// warp that touched the pair reduces them with shuffles and adds its ten
// partials to a shared [10][chunk] accumulator (shared-memory atomics,
// eight warps contend); after the chunk, one thread per pair adds the
// block totals to dtable with global atomics, so each (pair, tile) costs
// at most ten global atomics plus two for absgrad. Float atomics reorder
// the sums from run to run: parity with the plain version is relative.
#include "composite_common.cuh"

namespace {

using namespace gs;

constexpr int NACC = 10;  // sx sy dca dcb dcc dopa dr dg db dd
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gid_sorted,
                     const int* __restrict__ tile_starts,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ g_out,
                     float* __restrict__ dtable, float* __restrict__ absgrad,
                     int ntx, int nty, int tile, int chunk,
                     int want_absgrad) {
  extern __shared__ float smem[];
  float* s = smem;                        // [NATTR][chunk] pair attributes
  float* acc = smem + NATTR * chunk;      // [NACC][chunk] block sums
  int* s_gid = reinterpret_cast<int*>(acc + NACC * chunk);  // [chunk]

  const int t = blockIdx.x;
  const int start = tile_starts[t], end = tile_starts[t + 1];
  const int c0 = (start / chunk) * chunk;
  const int pixels = tile * tile;
  const int ppt = (pixels + THREADS - 1) / THREADS;
  const float* fo = fwd_out + (size_t)t * OUT_ROWS * pixels;
  const float* go = g_out + (size_t)t * OUT_ROWS * pixels;
  const int nproc = (int)fo[ROW_NPROC * pixels];  // same for every pixel
  if (end <= start || nproc == 0) return;  // block-uniform
  const int tloc = t % (ntx * nty);
  const int px0 = (tloc % ntx) * tile, py0 = (tloc / ntx) * tile;
  const int lane = threadIdx.x & 31;

  float px[MAX_PPT], py[MAX_PPT], T[MAX_PPT], P[MAX_PPT], S[MAX_PPT];
  float comp[MAX_PPT];
  float gr[MAX_PPT], gg[MAX_PPT], gb[MAX_PPT], gd[MAX_PPT];
  bool has[MAX_PPT];
#pragma unroll
  for (int j = 0; j < MAX_PPT; ++j) {
    const int p = pixel_index(j, ppt);
    has[j] = j < ppt && p < pixels;
    px[j] = (float)(px0 + p % tile) + 0.5f;
    py[j] = (float)(py0 + p / tile) + 0.5f;
    T[j] = 1.f;
    comp[j] = 0.f;
    gr[j] = gg[j] = gb[j] = gd[j] = S[j] = 0.f;
    if (!has[j]) continue;
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

  for (int i = 0; i < nproc; ++i) {
    const int base = c0 + i * chunk;
    __syncthreads();  // previous chunk's shared data fully consumed
    load_chunk(table, gid_sorted, base, start, end, chunk, s, s_gid);
    for (int x = threadIdx.x; x < NACC * chunk; x += THREADS) acc[x] = 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) P[j] = 1.f;
    for (int k = 0; k < chunk; ++k) {
      const float mx = s[0 * chunk + k], my = s[1 * chunk + k];
      const float ca = s[2 * chunk + k], cbb = s[3 * chunk + k];
      const float cc = s[4 * chunk + k], opa = s[5 * chunk + k];
      const float r = s[6 * chunk + k], g = s[7 * chunk + k];
      const float b = s[8 * chunk + k], d = s[9 * chunk + k];
      float v[NACC];
#pragma unroll
      for (int c = 0; c < NACC; ++c) v[c] = 0.f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < MAX_PPT; ++j) {
        if (!has[j]) continue;
        const Alpha a = alpha_at(px[j], py[j], mx, my, ca, cbb, cc, opa);
        if (!a.ok) continue;
        any = true;
        const float om = 1.f - a.alpha;
        const float inv1m = 1.f / om;
        const float tk = T[j] * P[j];
        const float w = a.alpha * tk;
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
        if (a.araw <= ALPHA_MAX) {  // unclamped: alpha = opa * e
          const float de = dalpha * a.e;
          const float dsig = de * (-opa);
          const float dsx = dsig * a.dx, dsy = dsig * a.dy;
          v[0] += dsx;
          v[1] += dsy;
          v[2] += dsx * a.dx;
          v[3] += dsx * a.dy;
          v[4] += dsy * a.dy;
          v[5] += de;
        }
        P[j] *= om;
      }
      if (__any_sync(FULL, any)) {  // warp-uniform
#pragma unroll
        for (int c = 0; c < NACC; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[c] += __shfl_down_sync(FULL, v[c], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < NACC; ++c)
            if (v[c] != 0.f) atomicAdd(&acc[c * chunk + k], v[c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_PPT; ++j) T[j] *= P[j];
    __syncthreads();
    for (int k = threadIdx.x; k < chunk; k += THREADS) {
      const int gid = s_gid[k];
      if (gid < 0) continue;  // row outside this tile's range
      const float sx = acc[0 * chunk + k], sy = acc[1 * chunk + k];
      const float ca = s[2 * chunk + k], cbb = s[3 * chunk + k];
      const float cc = s[4 * chunk + k];
      const float dmx = -(2.f * ca * sx + cbb * sy);
      const float dmy = -(2.f * cc * sy + cbb * sx);
      float* row = dtable + (size_t)gid * PACK_COLS;
      const float vals[NATTR] = {dmx,
                                 dmy,
                                 acc[2 * chunk + k],
                                 acc[3 * chunk + k],
                                 acc[4 * chunk + k],
                                 acc[5 * chunk + k],
                                 acc[6 * chunk + k],
                                 acc[7 * chunk + k],
                                 acc[8 * chunk + k],
                                 acc[9 * chunk + k]};
#pragma unroll
      for (int c = 0; c < NATTR; ++c)
        if (vals[c] != 0.f) atomicAdd(&row[c], vals[c]);
      if (want_absgrad) {
        if (dmx != 0.f) atomicAdd(&absgrad[(size_t)gid * 2 + 0], fabsf(dmx));
        if (dmy != 0.f) atomicAdd(&absgrad[(size_t)gid * 2 + 1], fabsf(dmy));
      }
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const void* table, const void* gid_sorted,
                             const void* tile_starts, const void* fwd_out,
                             const void* g_out, void* dtable, void* absgrad,
                             int num_tiles, int ntx, int nty, int tile,
                             int chunk, int want_absgrad, void* stream) {
  if (num_tiles > 0) {
    const size_t smem =
        sizeof(float) * (NATTR + NACC) * chunk + sizeof(int) * chunk;
    composite_bwd_kernel<<<num_tiles, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(gid_sorted),
        static_cast<const int*>(tile_starts),
        static_cast<const float*>(fwd_out), static_cast<const float*>(g_out),
        static_cast<float*>(dtable), static_cast<float*>(absgrad), ntx, nty,
        tile, chunk, want_absgrad);
  }
  return static_cast<int>(cudaGetLastError());
}
